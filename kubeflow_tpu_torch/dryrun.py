"""The multi-device dry run: one training step on each mesh a slice of
``n`` devices can hold.

Port of ``__graft_entry__.dryrun_multichip`` (:60) with its
``_factor_mesh`` (:37): a main mesh with ``data``, ``fsdp``,
``pipeline`` and (at 16 and more) ``tensor`` axes, a checkpoint and
resume on it, then the expert pass (a dropless MoE on ``data × expert
× tensor``), the sequence pass (ring attention on ``data × sequence``
when the main mesh has none), the multislice pass (two slices with
``data`` across them), the pipeline pass and a 1F1B step (both on
``data × pipeline``). Each pass
takes one step on ``[device] * n``: ``device`` names the CPU or a card,
None takes the card (raising on a host without CUDA). Run: ``python -c
"from kubeflow_tpu_torch.dryrun import dryrun_multichip as d;
d(8, device='cpu')"``.
"""

import functools
import math
import shutil
import tempfile


def _flagship_config(transformer, **overrides):
    """The dry run's small flagship (GQA 8:2 where the heads allow)."""
    kw = dict(vocab_size=2048, d_model=256, n_layers=4, n_heads=8,
              n_kv_heads=2, max_seq=256, dtype="bfloat16",
              attention="flash")
    kw.update(overrides)
    return transformer.Config(**kw)


def _factor_mesh(n):
    """``n`` devices → ``(data, fsdp, sequence, tensor, pipeline)`` with
    the remainder on ``data`` (JAX's factorization)."""
    pipeline = 2 if n % 2 == 0 else 1
    rest = n // pipeline
    fsdp = 2 if rest % 2 == 0 else 1
    rest //= fsdp
    tensor = 2 if rest % 4 == 0 else 1
    rest //= tensor
    sequence = 2 if rest % 4 == 0 else 1
    data = rest // sequence
    assert data * fsdp * sequence * tensor * pipeline == n
    return data, fsdp, sequence, tensor, pipeline


def _lm_batch(rows, seq, vocab, seed):
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq),
                                                dtype=np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def dryrun_multichip(n_devices, device=None):
    """One step on each pass's mesh over ``[device] * n_devices``;
    raises if a loss or gradient is not finite → the summary line, also
    printed."""
    import torch

    from .compute import checkpoint as ckpt_lib
    from .compute import device as device_lib
    from .compute import mesh as mesh_lib
    from .compute import pipeline as pipe_lib
    from .compute import train
    from .compute.models import transformer

    dev = device_lib.resolve(device)
    devices = [dev] * n_devices
    opt = train.make_optimizer(learning_rate=1e-3, warmup_steps=2,
                               total_steps=10)

    def one_step(cfg, mesh, rows, seed, init_seed):
        state = train.init_state(
            functools.partial(transformer.init_params, cfg), opt, mesh=mesh,
            logical_axes=transformer.logical_axes(cfg),
            generator=torch.Generator().manual_seed(init_seed))
        step = train.make_train_step(
            train.plain_loss(transformer.loss_fn, cfg), opt, mesh)
        batch = _lm_batch(rows, cfg.max_seq, cfg.vocab_size, seed)
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
        return state, step, batch, loss

    data, fsdp, sequence, tensor, pipeline = _factor_mesh(n_devices)
    mesh = mesh_lib.make_mesh(
        mesh_lib.MeshSpec(data=data, fsdp=fsdp, sequence=sequence,
                          tensor=tensor, pipeline=pipeline), devices=devices)
    cfg = _flagship_config(
        transformer, vocab_size=128, d_model=8 * tensor, n_layers=2,
        n_heads=2 * max(tensor, 1), max_seq=16 * max(sequence, 1),
        dtype="float32", attention="ring" if sequence > 1 else "dense",
        pipeline_stages=pipeline,
        pipeline_microbatches=2 * pipeline if pipeline > 1 else 0)
    # each batch piece cuts its own rows into the microbatches (JAX cuts
    # the global batch, so it needs only their lcm)
    rows = max(2, data * fsdp) * (cfg.pipeline_microbatches or 1)
    state, step, batch, loss = one_step(cfg, mesh, rows, 1, 0)

    # checkpoint and resume on the same mesh: the multichip half of the
    # slice worker's resume path
    ckdir = tempfile.mkdtemp(prefix="dryrun-ckpt-")
    try:
        ckpt = ckpt_lib.Checkpointer(ckdir, async_save=False)
        ckpt.save(state)
        ckpt.close()
        fresh = train.init_state(
            functools.partial(transformer.init_params, cfg), opt, mesh=mesh,
            logical_axes=transformer.logical_axes(cfg),
            generator=torch.Generator().manual_seed(7))
        resumed = ckpt_lib.Checkpointer(ckdir, async_save=False).restore(
            fresh)
        if resumed is None or resumed.step != 1:
            raise AssertionError("resume")
        resumed, metrics = step(resumed, batch)
        if resumed.step != 2 or not math.isfinite(float(metrics["loss"])):
            raise AssertionError("the resumed step")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # the expert pass: a dropless MoE over data × expert × tensor
    ep = 2 if (n_devices // max(tensor, 1)) % 2 == 0 else 1
    moe_mesh = mesh_lib.make_mesh(
        mesh_lib.MeshSpec(data=-1, expert=ep, tensor=tensor),
        devices=devices)
    moe_cfg = _flagship_config(
        transformer, vocab_size=128, d_model=8 * max(tensor, 1), n_layers=2,
        n_heads=max(tensor, 2), max_seq=16, dtype="float32",
        attention="dense", moe_experts=2 * ep, moe_top_k=2,
        moe_dropless=True)
    moe_loss = one_step(moe_cfg, moe_mesh, max(2, n_devices // ep), 3, 2)[3]

    # the sequence pass, when the main mesh has no sequence axis
    sp_loss = None
    sp = 2 if n_devices % 2 == 0 else 1
    if sequence == 1 and sp > 1:
        sp_mesh = mesh_lib.make_mesh(
            mesh_lib.MeshSpec(data=-1, sequence=sp), devices=devices)
        sp_cfg = _flagship_config(
            transformer, vocab_size=128, d_model=16, n_layers=2, n_heads=2,
            max_seq=16 * sp, dtype="float32", attention="ring")
        sp_loss = one_step(sp_cfg, sp_mesh, max(2, n_devices // sp), 5,
                           4)[3]

    # the multislice pass: two slices, data across them
    ms_loss, ms_spec = None, None
    if n_devices >= 4 and n_devices % 2 == 0:
        half = n_devices // 2
        ms_tensor = 2 if half % 2 == 0 else 1
        ordered, ms_spec = mesh_lib.multislice_layout(
            [devices[:half], devices[half:]], tensor=ms_tensor)
        ms_mesh = mesh_lib.make_mesh(ms_spec, devices=ordered)
        ms_cfg = _flagship_config(
            transformer, vocab_size=128, d_model=8 * ms_tensor, n_layers=2,
            n_heads=2 * max(ms_tensor, 1), max_seq=16, dtype="float32",
            attention="dense")
        ms_loss = one_step(ms_cfg, ms_mesh, max(2, ms_spec.data), 8, 6)[3]

    # the pipeline pass: GPipe over data × pipeline, then a 1F1B step
    pp_loss = f1b_loss = None
    pp = 2 if n_devices % 2 == 0 else 1
    if pp > 1:
        pp_mesh = mesh_lib.make_mesh(
            mesh_lib.MeshSpec(data=-1, pipeline=pp), devices=devices)
        pp_cfg = _flagship_config(
            transformer, vocab_size=128, d_model=16, n_layers=2, n_heads=2,
            max_seq=16, dtype="float32", attention="dense",
            pipeline_stages=pp, pipeline_microbatches=pp)
        pp_loss = one_step(pp_cfg, pp_mesh, max(2 * pp, n_devices // pp * pp),
                           10, 9)[3]
        f1b_loss = _one_1f1b(torch, pipe_lib, pp_mesh, dev)

    line = (f"dryrun_multichip({n_devices}) on {dev}: mesh data={data} "
            f"fsdp={fsdp} sequence={sequence} tensor={tensor} "
            f"pipeline={pipeline}, loss={loss:.4f}, ckpt-resume step 1→2; "
            f"moe mesh expert={ep} dropless loss={moe_loss:.4f}")
    if pp_loss is not None:
        line += (f"; pp mesh pipeline={pp} loss={pp_loss:.4f}; 1f1b "
                 f"pipeline={pp} loss={f1b_loss:.4f}")
    if sp_loss is not None:
        line += f"; sp mesh sequence={sp} loss={sp_loss:.4f}"
    if ms_loss is not None:
        line += (f"; multislice slices=2 data={ms_spec.data} "
                 f"tensor={ms_spec.tensor} loss={ms_loss:.4f}")
    line += " — OK"
    print(line)
    return line


def _one_1f1b(torch, pipe_lib, mesh, dev):
    """A 1F1B step of a toy stack over ``mesh`` (the GPipe pass's
    ``data × pipeline``, as JAX runs it under ``jax.set_mesh``), 4
    microbatches of one row a data coordinate → its loss, the loss and
    gradients required finite."""
    g = torch.Generator().manual_seed(11)
    params = {"embed": {"emb": 0.3 * torch.randn((64, 16), generator=g)},
              "layers": {"w": 0.3 * torch.randn((2, 16, 16), generator=g)},
              "head": {"out": 0.3 * torch.randn((16, 64), generator=g)}}
    params = {k: {n: t.to(dev) for n, t in v.items()}
              for k, v in params.items()}
    tok = torch.randint(0, 64, (4 * mesh.shape["data"], 16),
                        generator=g)

    def embed(ep, t):
        return ep["emb"][t]

    def layer(lp, x):
        return x + torch.tanh(x @ lp["w"]), None

    def loss_fn(hp, y, tgt):
        logits = y @ hp["out"]
        lab = torch.gather(logits, -1, tgt[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - lab).mean()

    loss, grads = pipe_lib.train_1f1b(embed, layer, loss_fn, params, tok,
                                      torch.roll(tok, -1, 1), 4, mesh)
    from .compute.train import tree_leaves
    if not math.isfinite(float(loss)) or not all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(grads)):
        raise AssertionError("1f1b loss or grads not finite")
    return float(loss)
