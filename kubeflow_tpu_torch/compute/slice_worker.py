"""Slice worker — the training-loop entry point each worker of a gang
runs.

Port of ``kubeflow_tpu/compute/slice_worker.py``, step for step. The
TpuSlice controller schedules one pod per worker and injects
``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES`` and
``JAX_COORDINATOR_ADDRESS`` (the platform's names, kept). Every worker:

1. joins the gang (``mesh.initialize_distributed``: a
   ``torch.distributed`` process group over TCP at the coordinator,
   ``nccl`` when each worker has a card of its own, ``gloo`` on the CPU
   or where workers share a card),
2. builds its part of the gang's mesh (``MeshSpec(data=-1, fsdp=,
   tensor=)``; only ``data`` crosses processes, each worker holding one
   ``data`` coordinate with ``fsdp × tensor`` positions on its device),
3. ``restore_or_init`` from the checkpoint directory,
4. trains, feeding only its own rows of each global batch: the train
   step sums the loss's statistics and the gradients over the gang, so
   every worker applies the same bytes and keeps whole replicas. Worker
   0 writes each checkpoint, then the gang waits at a barrier until it
   is durable; every worker restores. On any worker's failure the
   controller restarts the whole gang, which resumes from the last
   durable step.

Deterministic fault injection: ``SLICE_WORKER_FAULT_AT_STEP=<n>`` makes
the worker exit with code 17 before step n, only on a fresh run
(``resumed`` False), and ``SLICE_WORKER_FAULT_WORKER=<id>`` scopes it to
one worker.

``SLICE_WORKER_DEVICE`` names the device (``cpu``, or a card such as
``cuda:0`` that every worker then shares); unset, each worker takes a
card (raising on a host without CUDA). It replaces JAX's
``SLICE_WORKER_PLATFORM``. JAX's persistent compile cache has no
counterpart: eager PyTorch compiles no program, and the kernels are
built once into ``build/``.

Run: ``python -m kubeflow_tpu_torch.cmd slice-worker --ckpt-dir ...
--steps N``
"""

import argparse
import json
import os
import sys
import time


def build_argparser():
    ap = argparse.ArgumentParser(prog="slice-worker")
    ap.add_argument("--steps", type=int, default=10,
                    help="train to this global step count")
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint dir (workspace PVC path)")
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--log", default="",
                    help="append one JSON line per step here")
    ap.add_argument("--batch-per-process", type=int, default=4)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--tensor", type=int, default=1)
    ap.add_argument("--seq", type=int, default=32)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..obs import export as obs_export
    from ..obs import tracing
    from . import checkpoint as ckpt_lib
    from . import mesh as mesh_lib
    from . import telemetry as telem
    from . import train
    from .models import transformer

    named = os.environ.get("SLICE_WORKER_DEVICE") or None
    joined = mesh_lib.initialize_distributed(device=named)
    pid = dist.get_rank() if joined else 0
    n_proc = dist.get_world_size() if joined else 1
    device = mesh_lib.process_device(named, pid, n_proc)
    mesh = mesh_lib.make_mesh(
        mesh_lib.MeshSpec(data=-1, fsdp=args.fsdp, tensor=args.tensor),
        devices=[device] * (args.fsdp * args.tensor),
        group=dist.group.WORLD if joined else None)

    cfg = transformer.Config(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4,
        max_seq=args.seq, dtype="float32", attention="dense")
    opt = train.make_optimizer(learning_rate=3e-3, warmup_steps=1,
                               total_steps=max(args.steps, 2))

    def init():
        return train.init_state(
            lambda g, device: transformer.init_params(cfg, g, device=device),
            opt, mesh=mesh, logical_axes=transformer.logical_axes(cfg),
            generator=torch.Generator().manual_seed(0))

    # synchronous saves: a step's checkpoint is durable before the next
    # step runs, so fault-at-step-n always resumes from the latest
    # completed interval (deterministic for the gang restart)
    ckpt, state, resumed = ckpt_lib.restore_or_init(
        args.ckpt_dir, init, save_interval_steps=args.ckpt_every,
        async_save=False)
    step_fn = train.make_train_step(
        train.plain_loss(transformer.loss_fn, cfg), opt, mesh)

    def save(force=False):
        """Worker 0 writes (every worker holds whole replicas); the gang
        then waits until the write is durable."""
        if pid == 0:
            ckpt.save(state, force=force)
        if joined:
            dist.barrier()

    def global_batch(step):
        """The step's global batch, the same on every worker; this
        worker feeds its own rows (the train step cuts them over its
        positions)."""
        rng = np.random.default_rng(1000 + step)
        full = rng.integers(
            0, cfg.vocab_size,
            (args.batch_per_process * n_proc, args.seq), dtype=np.int32)
        local = full[pid * args.batch_per_process:
                     (pid + 1) * args.batch_per_process]
        return {"tokens": local, "targets": np.roll(local, -1, axis=1)}

    fault_at = int(os.environ.get("SLICE_WORKER_FAULT_AT_STEP", "-1"))
    fault_worker = os.environ.get("SLICE_WORKER_FAULT_WORKER")
    my_id = int(os.environ.get("TPU_WORKER_ID", pid))
    if fault_worker is not None and int(fault_worker) != my_id:
        fault_at = -1
    if resumed:
        fault_at = -1   # fault injection targets the fresh run only
    log_f = open(args.log, "a") if args.log else None

    def log(**kw):
        kw.update(process=pid, t=time.time())
        line = json.dumps(kw)
        if log_f:
            log_f.write(line + "\n")
            log_f.flush()
        print(line, flush=True)

    # fleet telemetry: shard exporter (none without a workspace), the
    # step/MFU/goodput families, and the gang trace continued from the
    # controller-injected TRACEPARENT
    exporter = obs_export.start_exporter()
    global_batch_rows = args.batch_per_process * n_proc
    card_peak = telem.mesh_peak_flops(mesh)
    tele = telem.TrainTelemetry(
        "transformer",
        flops_per_step=(transformer.flops_per_token(cfg)
                        * global_batch_rows * args.seq),
        # the flops are the GLOBAL batch's, so the MFU denominator is
        # the gang's peak (None on the CPU: no MFU)
        peak=None if card_peak is None else card_peak * n_proc,
        resumed=resumed)

    log(event="joined", joined=joined, resumed=resumed,
        start_step=int(state.step), processes=n_proc,
        devices=mesh.size * n_proc, device=str(device),
        backend=dist.get_backend() if joined else None,
        mesh=str(mesh.global_shape))

    try:
        with tracing.span("slice-worker",
                          traceparent=os.environ.get("TRACEPARENT"),
                          worker=my_id, resumed=resumed,
                          start_step=int(state.step)):
            while int(state.step) < args.steps:
                step_no = int(state.step)
                if step_no == fault_at:
                    log(event="fault-injected", step=step_no)
                    os._exit(17)
                with tracing.span("train.step", step=step_no):
                    state, metrics = step_fn(state, global_batch(step_no))
                    loss = float(metrics["loss"])   # waits for the step
                tele.step()
                t_ck = time.perf_counter()
                with tracing.span("train.checkpoint", step=int(state.step)):
                    save()
                tele.checkpoint(time.perf_counter() - t_ck)
                log(event="step", step=int(state.step), loss=loss)

            # the last step's save is the gang's decision: every worker
            # reads the listing before worker 0 may write that step, or
            # a worker that reads after the write skips the save's
            # barrier and leaves worker 0 waiting in it
            final = int(state.step) not in ckpt.all_steps()
            if joined:
                dist.barrier()
            if final:
                save(force=True)
            ckpt.close()
        log(event="done", step=int(state.step))
    finally:
        if exporter is not None:
            exporter.stop()
        if joined:
            dist.destroy_process_group()
        if log_f:
            log_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
