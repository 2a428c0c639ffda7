"""The port's training mesh against the JAX package's, on the CPU in fp32.

JAX trains on ``jax.devices()[:n]`` of the forced 8-device CPU mesh
(``tests/conftest.py``), the port on a mesh of ``["cpu"] * n`` with the
same axis sizes. Weights come from JAX ``init_params`` through numpy
(``params_from_jax``, ``tree_from_jax``) and the batches are the same
numpy arrays. Each case runs 3 steps of JAX's ``make_train_step``, of
the port's mesh step and of the port's unsharded step, mirroring
``tests/test_compute_models.py``. The batches: the transformer, BERT
and the MLP see 3 distinct batches of a seeded stream; ResNet repeats
one, as JAX's ``TestResNet`` and ``test_torch_resnet.py`` do. Both are
for the rule on params below, which rounding noise through Adam can
break in the port's unsharded step as much as in its mesh step: one
batch repeated makes the second update exactly ±lr on every element
(the first two gradients are equal), so an element whose gradient is
zero up to rounding moves by up to 2·lr, and that move shifted 1.2 % of
a GQA transformer leaf's third update by 1e-5; three distinct batches
put ResNet-18's BN biases, whose gradients are near rounding, at 0.085 %
of the model beyond 1e-6 in the port's unsharded step against JAX
(0.101 % for the mesh step, 0.034 % with the batch repeated).

Tolerances, with their reasons:

- per-step loss and metrics: rtol 1e-5 (fp32 reduction order: the
  pieces' sums are added in another order than one global sum);
- params after 3 steps: ``test_torch_train.py``'s rule — within 1e-6,
  or within 2·lr per nonzero-rate update for at most 0.1 % of the
  elements (Adam's sign flips at near-zero gradients), per leaf; for
  ResNet and BERT the share is taken over the whole model, as
  ``test_torch_resnet.py`` and ``test_torch_bert.py`` take it (BERT's
  key bias, rounding noise, held to the steps' size only), ResNet's
  statistics within 1e-4 after the first step (the one-pass variance
  cancels) and within the flips' 2·lr after the third;
- replicated copies: byte-equal after every step;
- checkpoints: the restored tensors equal the saved ones exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import data as j_data
from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import bert as jb
from kubeflow_tpu.compute.models import mlp as jm
from kubeflow_tpu.compute.models import resnet as jr
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import checkpoint as t_ckpt
from kubeflow_tpu_torch.compute import data as t_data
from kubeflow_tpu_torch.compute import mesh as t_mesh
from kubeflow_tpu_torch.compute import sharding as t_sharding
from kubeflow_tpu_torch.compute import telemetry as t_tel
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import bert as tb
from kubeflow_tpu_torch.compute.models import mlp as tm
from kubeflow_tpu_torch.compute.models import resnet as tr
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax, tree_from_jax

LR = 1e-3
STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _meshes(**sizes):
    n = int(np.prod(list(sizes.values())))
    return (j_mesh.make_mesh(devices=jax.devices()[:n], **sizes),
            t_mesh.make_mesh(devices=["cpu"] * n, **sizes))


def _port_cfg(module, jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(module.Config)}
    return module.Config(**{**fields, **kw})


def _opts():
    return (j_train.make_optimizer(LR, warmup_steps=1, total_steps=10),
            t_train.make_optimizer(LR, warmup_steps=1, total_steps=10))


def _assert_copies_equal(state):
    for leaf in (t_train.tree_leaves(state.params)
                 + t_train.tree_leaves(state.extra)
                 + t_train.tree_leaves(state.opt_state["mu"])
                 + t_train.tree_leaves(state.opt_state["nu"])):
        for group in leaf.sharding.copies:
            for q in group[1:]:
                assert torch.equal(leaf.pieces[q], leaf.pieces[group[0]])


def _assert_params_close(got, want, names, whole_model=False, noise=()):
    """``test_torch_train.py``'s rule: 1e-6, or 2·lr per nonzero-rate
    update on at most 0.1 % of the elements. Leaves named in ``noise``
    (BERT's key bias, whose gradient is zero analytically and rounding
    noise on both sides, so Adam steps it ±lr at random) are held to the
    steps' size only, as ``test_torch_bert.py`` holds them."""
    allowed = 2 * LR * (STEPS - 1)
    diffs = {n: np.abs(np.asarray(g) - np.asarray(w)).ravel()
             for n, g, w in zip(names, got, want)}
    assert len(got) == len(want) == len(names)
    assert max(d.max() for d in diffs.values()) <= allowed
    held = [d for n, d in diffs.items() if not any(k in n for k in noise)]
    for d in ([np.concatenate(held)] if whole_model else held):
        assert (d > 1e-6).mean() <= 1e-3


def _assert_history(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def _run(step, state, batches, after=None):
    history = []
    for batch in batches:
        state, m = step(state, batch)
        history.append({k: float(v) for k, v in m.items()})
        if after is not None:
            after(state)
    return state, history


def _parity(jloss, tloss, jinit, tinit, jaxes, taxes, batches, sizes,
            accum=1, extra=None, whole_model=False, noise=(), seen=None):
    """A step each on ``batches`` (3) of JAX's mesh step, the port's mesh
    step and the port's unsharded step → ``(jax, mesh, unsharded)``
    states, having held the three's metrics and params to each other.
    ``seen`` (a dict) collects each side's state after every step."""
    seen = {} if seen is None else seen

    def keep(side):
        return lambda state: seen.setdefault(side, []).append(state)

    jmesh, tmesh = _meshes(**sizes)
    jopt, topt = _opts()
    jstate = j_train.init_state(jinit, jopt, jmesh, jaxes,
                                jax.random.PRNGKey(0), extra=extra and
                                jax.tree.map(jnp.asarray, extra))
    jstep = j_train.make_train_step(jloss, jopt, jmesh, accum_steps=accum)
    jstate, jhist = _run(jstep, jstate,
                         [jax.tree.map(jnp.asarray, b) for b in batches],
                         after=lambda st: keep("jax")(_np(st.extra)))
    mstate = t_train.init_state(
        tinit, topt, mesh=tmesh, logical_axes=taxes,
        extra=extra and tree_from_jax(extra, device="cpu"))
    mstep = t_train.make_train_step(tloss, topt, mesh=tmesh,
                                    accum_steps=accum)
    mstate, mhist = _run(mstep, mstate, batches,
                         after=lambda st: (_assert_copies_equal(st), keep(
                             "mesh")(t_sharding.gather_tree(st.extra))))
    _, topt1 = _opts()
    ustate = t_train.init_state(
        tinit, topt1, device="cpu",
        extra=extra and tree_from_jax(extra, device="cpu"))
    ustep = t_train.make_train_step(tloss, topt1, accum_steps=accum)
    ustate, uhist = _run(ustep, ustate,
                         [t_data.to_device(b, "cpu") for b in batches])
    assert mstate.step == ustate.step == int(jstate.step) == STEPS
    _assert_history(mhist, jhist)
    _assert_history(mhist, uhist)
    got = t_train.tree_leaves(t_train.gather_params(mstate))
    names = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_leaves_with_path(jstate.params)]
    _assert_params_close(got, jax.tree.leaves(_np(jstate.params)), names,
                         whole_model, noise)
    _assert_params_close(got, [t.detach() for t in
                               t_train.tree_leaves(ustate.params)], names,
                         whole_model, noise)
    return jstate, mstate, ustate


# ------------------------------------------------------- the transformer

def _lm_batch(bs=8, seq=32, vocab=128, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (bs, seq),
                                                dtype=np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _lm_batches():
    """3 batches of 8 × 32 with random masks (a fifth masked out)."""
    out = []
    for i in range(STEPS):
        b = _lm_batch(seed=1 + i)
        b["mask"] = (np.random.default_rng(10 + i).random((8, 32)) < 0.8
                     ).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("kv,sizes", [
    (4, dict(data=2, tensor=4)),
    (2, dict(data=2, fsdp=2, tensor=2))], ids=["mha", "gqa"])
def test_transformer_mesh_step_matches_jax(attention, kv, sizes):
    """``tiny_cfg`` of ``test_compute_models.py`` (MHA on data=2,
    tensor=4; GQA 4:2 on data=2, fsdp=2, tensor=2), remat on (JAX's
    default): K3–K5's plain versions per shard against JAX's Pallas
    kernels in interpret mode."""
    jcfg = jt.Config(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=kv, max_seq=64, dtype="float32",
                     attention=attention)
    tcfg = _port_cfg(tt, jcfg)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    _parity(j_train.plain_loss(jt.loss_fn, jcfg),
            t_train.plain_loss(tt.loss_fn, tcfg),
            lambda k: jax.tree.map(jnp.asarray, params),
            lambda g, device: params_from_jax(params, device=device),
            jt.logical_axes(jcfg), tt.logical_axes(tcfg), _lm_batches(),
            sizes)


def test_transformer_one_position_mesh_is_the_unsharded_step():
    """A one-position mesh runs the model as on one device (its MoE
    included), so its steps equal the unsharded ones byte for byte; and
    ``mesh=None`` keeps plain tensors."""
    jcfg = jt.Config(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                     max_seq=16, dtype="float32", attention="dense",
                     moe_experts=2, d_ff=32, remat=False)
    tcfg = _port_cfg(tt, jcfg)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(3)))
    init = functools.partial(lambda g, device: params_from_jax(
        params, device=device))
    batch = _lm_batch(2, 16, 64)
    _, topt = _opts()
    mesh = t_mesh.make_mesh(devices=["cpu"])
    mstate = t_train.init_state(init, topt, mesh=mesh,
                                logical_axes=tt.logical_axes(tcfg))
    mstep = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, tcfg),
                                    topt, mesh=mesh)
    _, topt1 = _opts()
    ustate = t_train.init_state(init, topt1, device="cpu")
    assert all(torch.is_tensor(t) for t in t_train.tree_leaves(
        ustate.params))
    ustep = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, tcfg),
                                    topt1)
    mstate, mhist = _run(mstep, mstate, [batch] * STEPS)
    ustate, uhist = _run(ustep, ustate,
                         [t_data.to_device(batch, "cpu")] * STEPS)
    assert mhist == uhist and "moe_aux" in mhist[0]
    for a, b in zip(t_train.tree_leaves(t_train.gather_params(mstate)),
                    t_train.tree_leaves(ustate.params)):
        assert torch.equal(a, b.detach())


# ----------------------------------------------------------------- BERT

def test_bert_mesh_step_matches_jax_with_unequal_mask_counts():
    """``TestBert``'s config on data=2, fsdp=2, tensor=2: the pieces'
    masked-token counts differ, so a mean of per-piece losses would not
    be JAX's global one."""
    jcfg = jb.Config(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                     d_ff=128, max_seq=32, dtype="float32",
                     attention="dense", remat=False)
    tcfg = _port_cfg(tb, jcfg)
    params = _np(jb.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batches = [tb.mlm_batch(rng, 8, tcfg) for _ in range(STEPS)]
    for b in batches:
        counts = b["mask"].reshape(4, -1).sum(1)
        assert len(set(counts.tolist())) > 1, counts
    assert tb.logical_axes(tcfg) == jb.logical_axes(jcfg)
    _parity(j_train.plain_loss(jb.loss_fn, jcfg),
            t_train.plain_loss(tb.loss_fn, tcfg),
            lambda k: jax.tree.map(jnp.asarray, params),
            lambda g, device: tree_from_jax(params, device=device),
            jb.logical_axes(jcfg), tb.logical_axes(tcfg), batches,
            dict(data=2, fsdp=2, tensor=2), whole_model=True,
            noise=("bk",))


# ------------------------------------------------------------------ MLP

def _mlp_case(rows, in_dim=16, hidden=16, n_classes=4):
    jcfg = jm.Config(in_dim=in_dim, hidden=hidden, n_classes=n_classes)
    params = _np(jm.init_params(jcfg, jax.random.PRNGKey(0)))
    batches = []
    for i in range(STEPS):
        x = np.random.default_rng(1 + i).standard_normal(
            (rows, in_dim)).astype(np.float32)
        batches.append({"image": x,
                        "label": (x.sum(-1) > 0).astype(np.int32)})
    return jcfg, _port_cfg(tm, jcfg), params, batches


def test_mlp_mesh_step_matches_jax_on_data_8():
    jcfg, tcfg, params, batches = _mlp_case(16, in_dim=64, hidden=32,
                                            n_classes=10)
    assert tm.logical_axes(tcfg) == jm.logical_axes(jcfg)
    _parity(j_train.plain_loss(jm.loss_fn, jcfg),
            t_train.plain_loss(tm.loss_fn, tcfg),
            lambda k: jax.tree.map(jnp.asarray, params),
            lambda g, device: tree_from_jax(params, device=device),
            jm.logical_axes(jcfg), tm.logical_axes(tcfg), batches,
            dict(data=8))


def test_mlp_accumulation_on_data_2_fsdp_4_matches_the_big_batch():
    """``TestTrainEngine.test_grad_accumulation_matches_large_batch`` at
    32 rows: each of the 4 microbatches cuts into 8 pieces of one row
    (JAX's 16 rows would leave pieces of half a row, which JAX pads and
    the port refuses). The accumulated mesh step against JAX's, and
    against the big batch's one step."""
    jcfg, tcfg, params, batches = _mlp_case(32)
    micro = [{k: v.reshape((4, 8) + v.shape[1:]) for k, v in b.items()}
             for b in batches]
    _, mstate, _ = _parity(
        j_train.plain_loss(jm.loss_fn, jcfg),
        t_train.plain_loss(tm.loss_fn, tcfg),
        lambda k: jax.tree.map(jnp.asarray, params),
        lambda g, device: tree_from_jax(params, device=device),
        jm.logical_axes(jcfg), tm.logical_axes(tcfg), micro,
        dict(data=2, fsdp=4), accum=4)
    _, tmesh = _meshes(data=2, fsdp=4)
    _, topt = _opts()
    big = t_train.init_state(
        lambda g, device: tree_from_jax(params, device=device), topt,
        mesh=tmesh, logical_axes=tm.logical_axes(tcfg))
    step = t_train.make_train_step(t_train.plain_loss(tm.loss_fn, tcfg),
                                   topt, mesh=tmesh)
    big, _ = _run(step, big, batches)
    # a batch placed with a replicated leading accumulation dim (what
    # fit(spec=) pumps) takes the same steps as host microbatches
    _, topt2 = _opts()
    placed = t_train.init_state(
        lambda g, device: tree_from_jax(params, device=device), topt2,
        mesh=tmesh, logical_axes=tm.logical_axes(tcfg))
    step = t_train.make_train_step(t_train.plain_loss(tm.loss_fn, tcfg),
                                   topt2, mesh=tmesh, accum_steps=4)
    spec = (None, ("data", "fsdp"))
    placed, _ = _run(step, placed, [t_data.shard_batch(b, tmesh, spec)
                                    for b in micro])
    for a, b in zip(t_train.tree_leaves(t_train.gather_params(placed)),
                    t_train.tree_leaves(t_train.gather_params(mstate))):
        assert torch.equal(a, b)
    got = t_train.tree_leaves(t_train.gather_params(big))
    _assert_params_close(
        got, t_train.tree_leaves(t_train.gather_params(mstate)),
        [str(i) for i in range(len(got))])


# --------------------------------------------------------------- ResNet

def test_resnet_mesh_step_matches_jax_with_sync_bn():
    """ResNet-18, width 8, on data=4: each position's batch norm sees
    the global batch's statistics, so losses, gradients and the running
    statistics are JAX's (whose XLA psums them)."""
    jcfg = jr.Config(depth=18, n_classes=4, width=8, dtype="float32")
    tcfg = _port_cfg(tr, jcfg)
    params, stats = _np(jax.jit(functools.partial(jr.init_params, jcfg))(
        jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    batches = [{"image": x, "label": np.arange(8, dtype=np.int32) % 4}
               ] * STEPS
    jaxes, jsaxes = jr.logical_axes(jcfg)
    taxes, saxes = tr.logical_axes(tcfg)
    assert (taxes, saxes) == (jaxes, jsaxes)
    seen = {}
    jstate, mstate, ustate = _parity(
        j_train.stateful_loss(jr.loss_fn, jcfg),
        t_train.stateful_loss(tr.loss_fn, tcfg),
        lambda k: jax.tree.map(jnp.asarray, params),
        lambda g, device: tree_from_jax(params, device=device),
        jaxes, taxes, batches, dict(data=4), extra=stats,
        whole_model=True, seen=seen)
    allowed = 2 * LR * (STEPS - 1)
    got = t_train.tree_leaves(t_sharding.gather_tree(mstate.extra))
    for g, j, u in zip(got, jax.tree.leaves(_np(jstate.extra)),
                       t_train.tree_leaves(ustate.extra)):
        assert np.abs(g.numpy() - j).max() <= allowed
        assert np.abs(g.numpy() - u.numpy()).max() <= allowed
    # after one step (rate 0) the statistics are the global batch's
    want = jax.tree.leaves(seen["jax"][0])
    for g, w in zip(t_train.tree_leaves(seen["mesh"][0]), want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4)
    # per-position batch norm would not be JAX's: the statistics moved
    # from one piece alone differ
    alone = tr.apply(tree_from_jax(params, device="cpu"),
                     tree_from_jax(stats, device="cpu"),
                     torch.from_numpy(x[:2]), tcfg)[1]
    assert not np.allclose(t_train.tree_leaves(alone)[0].numpy(),
                           want[0], atol=1e-4)


# ------------------------------------------------------ the loop, eval

def test_fit_pumps_shard_batch_and_eval_is_the_global_batch():
    jcfg, tcfg, params, source = _mlp_case(8, in_dim=16, hidden=8)
    _, tmesh = _meshes(data=2, tensor=2)
    loss = t_train.plain_loss(tm.loss_fn, tcfg)

    def fresh():
        return t_train.init_state(
            lambda g, device: tree_from_jax(params, device=device),
            _opts()[1], mesh=tmesh, logical_axes=tm.logical_axes(tcfg))

    state = fresh()
    step = t_train.make_train_step(loss, _opts()[1], mesh=tmesh)
    seen = []
    state, m = t_train.fit(state, step, iter(source), tmesh,
                           on_step=lambda n, m: seen.append(m) or None)
    assert state.step == 3 and len(seen) == 3
    ev = t_train.make_eval_step(loss, tmesh)(state, source[0])
    want = tm.loss_fn(t_train.gather_params(state),
                      t_data.to_device(source[0], "cpu"), tcfg)[1]
    for k in want:
        np.testing.assert_allclose(float(ev[k]), float(want[k]), rtol=1e-6)
    assert not ev["loss"].requires_grad


def test_telemetry_mfu_peak_counts_distinct_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    one_card = t_mesh.Mesh([torch.device("cuda", 0)] * 4,
                           t_mesh.MeshSpec(data=2, tensor=2).resolved(4))
    two_cards = t_mesh.Mesh(
        [torch.device("cuda", 0), torch.device("cuda", 1)] * 2,
        t_mesh.MeshSpec(data=2, tensor=2).resolved(4))
    assert t_tel.mesh_peak_flops(one_card) == t_tel.peak_flops()
    assert t_tel.mesh_peak_flops(two_cards) == 2 * t_tel.peak_flops()
    assert t_tel.mesh_peak_flops(_meshes(data=2)[1]) is None
    tel = t_tel.TrainTelemetry("mesh-mfu-test", flops_per_step=1e12,
                               peak=t_tel.mesh_peak_flops(one_card))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tel.step()
    tel.step(seconds=0.5)
    assert tel.live_mfu() == pytest.approx(1e12 / 0.5 / 989e12)


# -------------------------------------------------------------- batches

def test_shard_batch_pieces_equal_jax():
    jmesh, tmesh = _meshes(data=2, fsdp=2, tensor=2)
    batch = _lm_batch(8, 16, 64)
    jpieces = j_data.shard_batch(batch, jmesh)
    tpieces = t_data.shard_batch(batch, tmesh)
    assert t_data.batch_sharding(tmesh).spec == tuple(j_data.BATCH_SPEC)
    for name, leaf in jpieces.items():
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for p, dev in enumerate(jmesh.devices.reshape(-1)):
            np.testing.assert_array_equal(tpieces[name].pieces[p].numpy(),
                                          by_dev[dev.id])


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("axis", ["sequence", "pipeline", "expert"])
def test_train_step_refuses_the_later_axes(axis):
    """The train step takes every axis now: on ``sequence`` (the ring),
    ``pipeline`` (two stages) and ``expert`` (a dropless MoE of 4
    experts, 2 a shard) one step of the transformer runs and its
    replicated copies stay byte-equal."""
    _, tmesh = _meshes(data=2, **{axis: 2})
    cfg = dataclasses.replace(
        _ckpt_cfg(), **({"attention": "ring"} if axis == "sequence"
                        else {"pipeline_stages": 2} if axis == "pipeline"
                        else {"moe_experts": 4, "moe_top_k": 2,
                              "moe_dropless": True}))
    opt = _opts()[1]
    state = t_train.init_state(functools.partial(tt.init_params, cfg), opt,
                               mesh=tmesh, logical_axes=tt.logical_axes(cfg))
    step = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, cfg), opt,
                                   mesh=tmesh)
    state, metrics = step(state, _lm_batch(4, 16, 64))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    _assert_copies_equal(state)
    if axis == "expert":
        assert np.isfinite(float(metrics["moe_aux"]))
        assert state.params["layers"]["we_gate"].pieces[0].shape[1] == 2


def test_refusals_name_what_does_not_fit():
    _, tmesh = _meshes(data=2, fsdp=2, tensor=2)
    opt = _opts()[1]
    cfg = tt.Config(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                    max_seq=16, dtype="float32", attention="dense",
                    moe_experts=2, d_ff=32)
    # MoE on a mesh of more than one position trains (its experts
    # replicated here: the mesh has no expert axis); experts that do not
    # divide over an expert axis are refused by name
    state = t_train.init_state(functools.partial(tt.init_params, cfg), opt,
                               mesh=tmesh, logical_axes=tt.logical_axes(cfg))
    step = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, cfg), opt,
                                   mesh=tmesh)
    state, metrics = step(state, _lm_batch(4, 16, 64))
    assert np.isfinite(float(metrics["moe_aux"]))
    _assert_copies_equal(state)
    with pytest.raises(ValueError, match="moe_experts=2 does not divide "
                                         "over the mesh's expert axis of 4"):
        tt._check_mesh(cfg, _meshes(expert=4)[1])
    # a dim that does not divide: placement names the leaf
    odd = dataclasses.replace(cfg, moe_experts=0, n_heads=1)
    with pytest.raises(ValueError, match="layers/wq: dim 2 of size 1"):
        t_train.init_state(functools.partial(tt.init_params, odd), opt,
                           mesh=tmesh, logical_axes=tt.logical_axes(odd))
    # a batch that does not divide over (data, fsdp)
    with pytest.raises(ValueError, match="batch 'tokens': dim 0 of size 6"):
        t_data.shard_batch(_lm_batch(6, 16, 64), tmesh)
    # the models name the config field
    for check, config, field in (
            (tt._check_mesh, dataclasses.replace(odd, n_heads=3,
                                                 n_kv_heads=1), "n_heads"),
            (tt._check_mesh, dataclasses.replace(cfg, moe_experts=0,
                                                 d_model=33), "d_model"),
            (tb._check_mesh, tb.Config(d_ff=31), "d_ff")):
        with pytest.raises(ValueError, match=f"{field}=\\d+ does not "
                                             f"divide"):
            check(config, tmesh)
    mlp_cfg = tm.Config(in_dim=16, hidden=5, n_classes=4)
    # a custom logical_axes tree that replicates every leaf places
    # what the default one cannot; the forward still refuses it
    replicated = {"layers": [{"w": (None, None), "b": (None,)}
                             for _ in range(mlp_cfg.n_layers + 1)]}
    state = t_train.init_state(functools.partial(tm.init_params, mlp_cfg),
                               opt, mesh=tmesh, logical_axes=replicated)
    x = np.zeros((4, 16), np.float32)
    with pytest.raises(ValueError, match="hidden=5 does not divide"):
        tm.loss_fn(state.params, t_data.shard_batch(
            {"image": x, "label": np.zeros(4, np.int32)}, tmesh), mlp_cfg)
    # params laid out otherwise than the forward computes on
    wide = dataclasses.replace(mlp_cfg, hidden=8)
    state = t_train.init_state(functools.partial(tm.init_params, wide),
                               opt, mesh=tmesh, logical_axes=replicated)
    with pytest.raises(ValueError, match="needs the default rules'"):
        tm.loss_fn(state.params, t_data.shard_batch(
            {"image": x, "label": np.zeros(4, np.int32)}, tmesh), wide)
    with pytest.raises(ValueError, match="a mesh or a device"):
        t_train.init_state(functools.partial(tm.init_params, wide), opt,
                           mesh=tmesh, device="cpu")


# ---------------------------------------------------------- checkpoints

def _ckpt_cfg():
    return tt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     max_seq=16, dtype="float32", attention="dense",
                     remat=False)


def _ckpt_state(mesh, seed=0):
    cfg = _ckpt_cfg()
    opt = t_train.make_optimizer(1e-2, warmup_steps=1, total_steps=20)
    state = t_train.init_state(
        functools.partial(tt.init_params, cfg), opt, mesh=mesh,
        logical_axes=tt.logical_axes(cfg),
        generator=torch.Generator().manual_seed(seed))
    return opt, state


def _same_state(a, b):
    assert a.step == b.step
    for x, y in zip(
            t_train.tree_leaves(t_sharding.gather_tree(
                [a.params, a.opt_state["mu"], a.opt_state["nu"]])),
            t_train.tree_leaves(t_sharding.gather_tree(
                [b.params, b.opt_state["mu"], b.opt_state["nu"]]))):
        assert torch.equal(x, y)
    assert a.opt_state["count"] == b.opt_state["count"]


def test_checkpoint_round_trip_keeps_the_placement(tmp_path):
    """``TestCheckpoint.test_save_restore_roundtrip_sharded``: 3 mesh
    steps, a save, a restore into a fresh state of another seed."""
    _, mesh = _meshes(data=2, fsdp=2, tensor=2)
    opt, state = _ckpt_state(mesh)
    step = t_train.make_train_step(
        t_train.plain_loss(tt.loss_fn, _ckpt_cfg()), opt, mesh=mesh)
    state, _ = _run(step, state, [_lm_batch(4, 16, 64)] * STEPS)
    ckpt = t_ckpt.Checkpointer(tmp_path / "ckpt", async_save=False)
    assert ckpt.save(state)
    assert ckpt.latest_step() == STEPS
    _, fresh = _ckpt_state(mesh, seed=9)
    restored = ckpt.restore(fresh)
    _same_state(restored, state)
    leaf = restored.params["layers"]["w_gate"]
    assert leaf.spec == (None, "fsdp", "tensor") and leaf.mesh is mesh
    for a, b in zip(leaf.pieces, state.params["layers"]["w_gate"].pieces):
        assert torch.equal(a, b) and a.requires_grad
    _assert_copies_equal(restored)
    ckpt.close()


def test_checkpoint_restores_onto_another_mesh_and_one_device(tmp_path):
    """``TestCrossMeshRestore``: saved on data=4, tensor=2, restored onto
    fsdp=2, sequence=2, data=2 and onto one device."""
    _, mesh_a = _meshes(data=4, tensor=2)
    _, state_a = _ckpt_state(mesh_a)
    ckpt = t_ckpt.Checkpointer(tmp_path / "xmesh", async_save=False)
    ckpt.save(state_a)
    ckpt.close()
    _, mesh_b = _meshes(fsdp=2, sequence=2, data=2)
    _, target = _ckpt_state(mesh_b, seed=7)
    restored = t_ckpt.Checkpointer(tmp_path / "xmesh").restore(target)
    _same_state(restored, state_a)
    leaf = restored.params["layers"]["wq"]
    assert leaf.mesh is mesh_b and leaf.pieces[0].shape == (2, 16, 4, 8)
    opt = t_train.make_optimizer(1e-2, warmup_steps=1, total_steps=20)
    single = t_train.init_state(
        functools.partial(tt.init_params, _ckpt_cfg()), opt, device="cpu")
    restored = t_ckpt.Checkpointer(tmp_path / "xmesh").restore(single)
    for a, b in zip(t_train.tree_leaves(restored.params),
                    t_train.tree_leaves(t_train.gather_params(state_a))):
        assert torch.is_tensor(a) and torch.equal(a.detach(), b)


def test_restore_or_init_on_a_data_8_mesh(tmp_path):
    _, mesh = _meshes(data=8)
    ckpt, state, resumed = t_ckpt.restore_or_init(
        tmp_path / "c", lambda: _ckpt_state(mesh)[1], async_save=False)
    assert not resumed
    state.step = 7
    ckpt.save(state)
    ckpt.wait()
    ckpt2, again, resumed = t_ckpt.restore_or_init(
        tmp_path / "c", lambda: _ckpt_state(mesh, seed=3)[1],
        async_save=False)
    assert resumed and again.step == 7
    _same_state(again, state)
