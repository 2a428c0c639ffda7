"""Process entry points of the port —
``python -m kubeflow_tpu_torch.cmd <component>``.

``model-server`` is one replica of the JAX package's ``model-server``
on the port's ``ModelServer``, serving ``MODEL_NAME`` (default
``default``) in one of its branches:

- ``MODEL_GENERATE=1``: a stock TransformerLM from a seed behind
  ``POST /v1/models/<name>:generate``, sized by the same ``GEN_*`` knobs.
  ``GEN_ROLE`` (``prefill`` | ``decode`` | ``both``) gives the engine its
  disaggregation role: a prefill replica answers ``:prefill`` with page
  bundles, a decode replica takes them on ``:attach``. ``GEN_MESH``
  (``tensor=N`` or a bare N; it wins over ``GEN_TP``) or ``GEN_TP`` > 1
  shards the engine over a tensor mesh: the first N cards, or N CPU
  shards under ``GEN_DEVICE=cpu``; a host with fewer cards exits
  non-zero naming the count. ``GEN_ROW_SHARD`` shards the row
  projections too (it needs the mesh), and ``GEN_CALIBRATE`` measures
  the collective share before serving.
- otherwise the unary ``:predict``/``:predictStream`` plane:
  ``MODEL_MODULE`` names a module whose ``register(server)`` installs
  the replica's models; else ``MODEL_DEVICE_MS`` > 0 serves a fake
  device, pure numpy, each row costing that many ms on the batcher's
  thread (a replica's capacity is exactly 1000/``MODEL_DEVICE_MS``
  rows/s); else the stock MLP (``MODEL_IN_DIM`` 64, ``MODEL_HIDDEN``
  128, ``MODEL_CLASSES`` 16, softmax) with weights drawn from
  :data:`SEED`.

``GEN_DEVICE`` is the replica's device knob in every branch: unset it
is the card, and a CUDA-less host exits through ``device.resolve``'s
error (there is no silent fallback); ``cpu`` asks for the CPU by name.
``SERVING_TRANSPORT`` picks the wire engine of either branch:
``threaded`` (the default) or ``async`` (one event loop; what the
ModelDeployment controller renders for every replica). The server logs
its transport, prints ``PORT <n>`` once serving and blocks until
SIGTERM/SIGINT, then stops.

``slice-worker`` is one worker of a training gang
(``compute/slice_worker.py``): it joins the gang from the
``TPU_WORKER_*`` env, trains the JAX entry's small transformer with the
gang's gradients summed, checkpoints and resumes. ``SLICE_WORKER_DEVICE``
names its device (``cpu``); unset, it takes a card.
"""

import logging
import os
import signal
import threading

#: the seed of the stock model's weights (the JAX entry uses
#: ``PRNGKey(0)``; the port draws its own numbers from this seed)
SEED = 0

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _flag(name):
    return os.environ.get(name, "").strip().lower() in _TRUE


def _tp():
    """``GEN_MESH`` ("tensor=N" or a bare N) wins over ``GEN_TP``."""
    mesh = os.environ.get("GEN_MESH", "")
    return int(mesh.rpartition("=")[2] or os.environ.get("GEN_TP", "1")
               or 1)


#: the disaggregation roles ``GEN_ROLE`` may name
ROLES = ("prefill", "decode", "both")


def _gen_role():
    """``GEN_ROLE`` (default ``both``) → the engine's role; any other
    value exits non-zero by name."""
    role = (os.environ.get("GEN_ROLE") or "both").strip()
    if role not in ROLES:
        raise SystemExit(f"GEN_ROLE={role!r} is not a role: "
                         f"{' | '.join(ROLES)}")
    return role


def _block(*cleanup):
    """Wait for SIGTERM/SIGINT, then run the cleanup callbacks."""
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    for fn in cleanup:
        try:
            fn()
        except Exception:
            logging.exception("shutdown cleanup failed")


def _gen_mesh(dev):
    """``GEN_MESH``/``GEN_TP`` → the engine's tensor mesh, or None at 1
    (the unsharded engine, no mesh machinery; JAX
    ``cmd/__init__.py:289-297``). ``dev`` is ``GEN_DEVICE`` resolved: on
    the CPU the mesh is ``tp`` CPU shards; otherwise the first ``tp``
    cards, and a host with fewer exits non-zero naming the count."""
    tp = _tp()
    if tp <= 1:
        return None
    from ..compute import mesh as mesh_lib
    if dev is not None and dev.type == "cpu":
        return mesh_lib.mesh_for_generation(tensor=tp, devices=[dev] * tp)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if tp > cards:
        raise SystemExit(f"GEN_TP={tp} (GEN_MESH/GEN_TP) needs {tp} CUDA "
                         f"cards, this host has {cards}")
    return mesh_lib.mesh_for_generation(tensor=tp)


def _gen_qos_ledger():
    """The replica's token ledger from ``QOS_TENANTS`` — None when
    unset, so the engine skips every ledger branch."""
    if not (os.environ.get("QOS_TENANTS") or "").strip():
        return None
    from ..qos import buckets
    return buckets.from_env()


def build_engine(name="default"):
    """The ``GEN_*`` knobs → a started ``GenerationEngine`` of a stock
    TransformerLM (random weights from :data:`SEED`) on ``GEN_DEVICE``
    (unset: the card)."""
    import torch

    from ..compute import device as device_lib
    from ..compute import generate as gen_lib
    from ..compute.models import transformer

    role = _gen_role()
    gen_device = os.environ.get("GEN_DEVICE") or None
    mesh = _gen_mesh(torch.device(gen_device) if gen_device else None)
    dev = device_lib.resolve(gen_device)
    cfg = transformer.Config(
        vocab_size=int(os.environ.get("GEN_VOCAB", "512")),
        d_model=int(os.environ.get("GEN_D_MODEL", "128")),
        n_layers=int(os.environ.get("GEN_LAYERS", "2")),
        n_heads=int(os.environ.get("GEN_HEADS", "4")),
        max_seq=int(os.environ.get("GEN_MAX_CONTEXT", "256")),
        dtype=os.environ.get("GEN_DTYPE", "float32"),
        attention="dense", remat=False, scan_layers=True)
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(SEED), device=dev)
    # GEN_SPEC_K/GEN_DRAFT: a draft from the target's first GEN_DRAFT
    # layers; GEN_DRAFT_DAMPEN scales the served target's upper layers
    # so random weights give a measurable acceptance (a test-pair knob)
    spec_k = int(os.environ.get("GEN_SPEC_K", "0") or 0)
    draft_params = draft_cfg = None
    if spec_k > 0:
        draft_layers = int(os.environ.get("GEN_DRAFT", "0") or 0)
        if not draft_layers:
            raise SystemExit("GEN_SPEC_K > 0 needs GEN_DRAFT=<draft layers>")
        dampen = os.environ.get("GEN_DRAFT_DAMPEN", "")
        if dampen:
            logging.warning(
                "GEN_DRAFT_DAMPEN=%s: the SERVED target model's layers "
                ">= %d are residual-dampened (test-pair knob; do not set "
                "on a real checkpoint)", dampen, draft_layers)
        params, draft_params, draft_cfg = gen_lib.truncated_draft(
            params, cfg, draft_layers,
            dampen=float(dampen) if dampen else None)
    engine = gen_lib.GenerationEngine(
        params, cfg, draft_params=draft_params, draft_config=draft_cfg,
        spec_k=spec_k,
        max_slots=int(os.environ.get("GEN_SLOTS", "4")),
        block_size=int(os.environ.get("GEN_BLOCK_SIZE", "16")),
        num_blocks=int(os.environ.get("GEN_BLOCKS", "0")) or None,
        kv_dtype=os.environ.get("GEN_KV_DTYPE") or None,
        admission=os.environ.get("GEN_ADMISSION", "continuous"),
        prefix_cache=os.environ.get(
            "GEN_PREFIX_CACHE", "1").lower() not in _FALSE,
        attn_backend=os.environ.get("GEN_ATTN_BACKEND", "paged")
        or "paged",
        prefill_chunk=int(os.environ.get("GEN_PREFILL_CHUNK", "0") or 0)
        or None,
        # QOS_TENANTS: the engine's own token ledger; GEN_PREEMPTION=0
        # is strict FIFO that never suspends a slot
        qos=_gen_qos_ledger(),
        preemption=os.environ.get("GEN_PREEMPTION", "1").lower()
        not in _FALSE,
        # GEN_ROLE: prefill | decode | both; a role-split fleet's router
        # sends :prefill to prefill replicas and :attach to decode ones
        role=role, name=name,
        # GEN_MESH/GEN_TP: the mesh names the devices; GEN_ROW_SHARD
        # (the tolerance-tier layout) needs it, and the engine refuses
        # it without one, as JAX's does
        mesh=mesh, row_shard=_flag("GEN_ROW_SHARD"),
        device=None if mesh is not None else dev)
    if _flag("GEN_CALIBRATE"):
        # one decode-step calibration before traffic arrives:
        # serving_generate_shard_collective_share
        engine.measure_collective_share()
    return engine


def _sleeper_model(name, device_ms, device):
    """The fake device of ``MODEL_DEVICE_MS``: each dispatched ROW costs
    ``device_ms``, serialized on the batcher's thread, so one replica's
    capacity is exactly 1000/``device_ms`` rows/s (replica scaling
    measurable without the host's compute in the way). Pure numpy."""
    import time

    import numpy as np

    from ..compute import serving

    class _SleeperModel(serving.ServedModel):
        def dispatch(self, x):
            self.last_used = time.monotonic()
            self.device_calls += 1
            x = np.asarray(x)
            time.sleep(device_ms * x.shape[0] / 1000.0)
            return x * 2.0, x.shape[0]

    return _SleeperModel(name, lambda x: x, device=device)


def build_unary_server(name="default"):
    """The unary branches → an unstarted ``ModelServer`` whose models
    run on ``GEN_DEVICE`` (unset: the card; resolved first, so a
    CUDA-less host raises before anything is built)."""
    import importlib

    import torch

    from ..compute import device as device_lib
    from ..compute import serving
    from ..compute.models import mlp

    dev = device_lib.resolve(os.environ.get("GEN_DEVICE") or None)
    server = serving.ModelServer(device=dev)
    module = os.environ.get("MODEL_MODULE", "")
    device_ms = float(os.environ.get("MODEL_DEVICE_MS", "0") or 0)
    if module:
        importlib.import_module(module).register(server)
    elif device_ms > 0:
        server._models[name] = _sleeper_model(name, device_ms, dev)
    else:
        cfg = mlp.Config(
            in_dim=int(os.environ.get("MODEL_IN_DIM", "64")),
            hidden=int(os.environ.get("MODEL_HIDDEN", "128")),
            n_classes=int(os.environ.get("MODEL_CLASSES", "16")))
        params = mlp.init_params(
            cfg, torch.Generator().manual_seed(SEED), device=dev)
        server.register(name, lambda x: torch.softmax(
            mlp.apply(params, x, cfg), dim=-1))
    return server


def model_server(argv=()):
    """One replica: the port's ``ModelServer`` on the
    ``SERVING_TRANSPORT`` transport (default threaded) serving
    ``MODEL_NAME`` (default ``default``) on ``HOST:PORT`` (default
    ``0.0.0.0:8500``; ``PORT=0`` picks a free port) — a generation
    engine under ``MODEL_GENERATE``, else the unary plane."""
    from ..compute import serving

    name = os.environ.get("MODEL_NAME", "default")
    if _flag("MODEL_GENERATE"):
        server = serving.ModelServer()
        server.register_generator(name, build_engine(name))
    else:
        server = build_unary_server(name)
    port = server.start(
        port=int(os.environ.get("PORT", "8500")),
        host=os.environ.get("HOST", "0.0.0.0"))
    logging.info("model-server serving on :%d (%s transport)", port,
                 server.transport)
    print(f"PORT {port}", flush=True)    # local-pod discovery
    _block(server.stop)


def slice_worker(argv=()):
    """One worker of a training gang (``compute/slice_worker.py``)."""
    from ..compute import slice_worker as sw
    raise SystemExit(sw.main(list(argv)))


COMPONENTS = {"model-server": model_server, "slice-worker": slice_worker}


def main(argv):
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if len(argv) < 1 or argv[0] not in COMPONENTS:
        names = "\n  ".join(sorted(COMPONENTS))
        raise SystemExit(
            f"usage: python -m kubeflow_tpu_torch.cmd <component>\n"
            f"components:\n  {names}")
    COMPONENTS[argv[0]](argv[1:])
