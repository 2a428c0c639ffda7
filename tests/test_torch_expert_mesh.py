"""The port's expert parallelism (the ``expert`` axis of its training
mesh) against the JAX package's, on the CPU in fp32.

JAX runs on ``jax.devices()[:n]`` of the forced 8-device CPU mesh, the
port on ``["cpu"] * n`` with the same axis sizes; weights come from JAX
``init_params`` through numpy (``params_from_jax``) and the batches are
the same numpy arrays. The cases mirror ``tests/test_compute_moe.py``
(:77, :122, :210, :247) and ``tests/test_compute_pipeline.py`` (:259,
:317). JAX's dropless MoE on an expert mesh takes ``lax.ragged_dot``
whatever ``moe_gmm`` says; the port's takes K6/K7's plain versions
(``moe_gmm=True``) or its plain ragged engine (``False``), both held to
the one JAX program.

Tolerances: loss and metrics (``moe_aux`` included) relative 1e-6, the
perplexity's through its log (the mean NLL);
each gradient leaf within 1e-5 of its max |g|; params after 3 steps by
``test_torch_train.py``'s rule; replicated copies byte-equal after every
step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import sharding as j_sharding
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import bert as jb
from kubeflow_tpu.compute.models import mlp as jm
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import checkpoint as t_ckpt
from kubeflow_tpu_torch.compute import data as t_data
from kubeflow_tpu_torch.compute import sharding as t_sharding
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import bert as tb
from kubeflow_tpu_torch.compute.models import mlp as tm
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax, tree_from_jax
from test_torch_train_mesh import (STEPS, _assert_copies_equal,
                                   _assert_params_close, _meshes, _mlp_case,
                                   _np, _opts, _parity, _port_cfg, _run)

METRIC_RTOL = 1e-6
GRAD_REL = 1e-5


def _jcfg(**kw):
    """``test_compute_moe.py``'s ``_cfg``."""
    base = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                max_seq=16, dtype="float32", attention="dense",
                remat=False, moe_experts=4)
    base.update(kw)
    return jt.Config(**base)


def _batches(cfg, rows=8, n=STEPS):
    out = []
    for i in range(n):
        toks = np.random.default_rng(1 + i).integers(
            0, cfg.vocab_size, (rows, cfg.max_seq), dtype=np.int32)
        out.append({"tokens": toks, "targets": np.roll(toks, -1, axis=1)})
    return out


@functools.lru_cache(maxsize=None)
def _params(jcfg, seed=0):
    return _np(jt.init_params(jcfg, jax.random.PRNGKey(seed)))


def _jax_grads(jcfg, params, batch, sizes):
    """JAX's loss, metrics and gradient leaves of ``loss_fn`` on the mesh
    ``sizes``, the params placed by ``logical_axes``."""
    jmesh = _meshes(**sizes)[0]
    placed = j_sharding.shard_tree(jax.tree.map(jnp.asarray, params), jmesh,
                                   jt.logical_axes(jcfg))
    with jax.set_mesh(jmesh):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jt.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg),
            has_aux=True))(placed)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.leaves(_np(grads)))


def _port_grads(tcfg, params, batch, sizes):
    """The port's loss, metrics and each leaf's logical gradient on the
    mesh ``sizes`` (each piece's gradient summed over its copies, as the
    train step sums them)."""
    _, tmesh = _meshes(**sizes)
    state = t_train.init_state(
        lambda g, device: params_from_jax(params, device=device),
        t_train.make_optimizer(), mesh=tmesh,
        logical_axes=tt.logical_axes(tcfg))
    leaves = t_train.tree_leaves(state.params)
    pieces = t_sharding.pieces_of(leaves)
    loss, metrics = tt.loss_fn(state.params,
                               t_data.shard_batch(batch, tmesh), tcfg)
    grads, _ = t_train._sum_copies(leaves, t_train._grads(loss, pieces))
    out, start = [], 0
    for leaf in leaves:
        n = len(leaf.pieces)
        out.append(t_sharding.Sharded(grads[start:start + n], leaf.sharding,
                                      leaf.shape).gather())
        start += n
    return (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
            out)


def _assert_metrics(got, want, rtol=METRIC_RTOL):
    """Every metric within ``rtol``; perplexity through its log, the
    mean NLL (a relative error of exp(x) is an absolute one of x: 2.4e-7
    of an NLL of 5.6, one fp32 sum order against another, is 1.4e-6 of
    its perplexity)."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if k == "perplexity":
            g, w = np.log(g), np.log(w)
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)


def _assert_grads(got, want, whole_model=False):
    """Each leaf within ``GRAD_REL`` of its max |g| (of the model's max
    |g| with ``whole_model``, for a leaf whose gradient is zero
    analytically and rounding noise on both sides)."""
    assert len(got) == len(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = top if whole_model else max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_REL * scale


def _steps_match_jax(jcfg, tcfg, params, batches, sizes):
    """3 steps of JAX's mesh step, the port's mesh step (copies
    byte-equal after each) and the port's unsharded step: metrics within
    ``METRIC_RTOL``, params by the rule."""
    jmesh, tmesh = _meshes(**sizes)
    jopt, topt = _opts()
    jstate = j_train.init_state(lambda k: jax.tree.map(jnp.asarray, params),
                                jopt, jmesh, jt.logical_axes(jcfg),
                                jax.random.PRNGKey(0))
    jstep = j_train.make_train_step(j_train.plain_loss(jt.loss_fn, jcfg),
                                    jopt, jmesh)
    jstate, jhist = _run(jstep, jstate,
                         [jax.tree.map(jnp.asarray, b) for b in batches])
    init = functools.partial(lambda g, device: params_from_jax(
        params, device=device))
    mstate = t_train.init_state(init, topt, mesh=tmesh,
                                logical_axes=tt.logical_axes(tcfg))
    mstep = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, tcfg),
                                    topt, mesh=tmesh)
    mstate, mhist = _run(mstep, mstate, batches, after=_assert_copies_equal)
    _, topt1 = _opts()
    ustate = t_train.init_state(init, topt1, device="cpu")
    ustep = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, tcfg),
                                    topt1)
    ustate, uhist = _run(ustep, ustate,
                         [t_data.to_device(b, "cpu") for b in batches])
    for m, j, u in zip(mhist, jhist, uhist):
        assert "moe_aux" in m
        _assert_metrics(m, j)
        _assert_metrics(m, u)
    got = t_train.tree_leaves(t_train.gather_params(mstate))
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jstate.params)]
    _assert_params_close(got, jax.tree.leaves(_np(jstate.params)), names)
    _assert_params_close(got, [t.detach() for t in
                               t_train.tree_leaves(ustate.params)], names)
    return mstate


@functools.lru_cache(maxsize=None)
def _jax_case(jcfg, sizes_items):
    sizes = dict(sizes_items)
    return _jax_grads(jcfg, _params(jcfg), _batches(jcfg)[0], sizes)


# -------------------------------------------------- data, expert, tensor

EP_CASES = {
    "capacity-top1": (dict(moe_top_k=1), ()),
    "capacity-top2": (dict(moe_top_k=2), ()),
    "dropless-gmm": (dict(moe_top_k=2, moe_dropless=True),
                     (("moe_gmm", True),)),
    "dropless-ragged": (dict(moe_top_k=2, moe_dropless=True),
                        (("moe_gmm", False),)),
}


@pytest.mark.parametrize("case", sorted(EP_CASES))
def test_expert_mesh_matches_jax(case):
    """``data=2, expert=2, tensor=2`` (JAX ``test_compute_moe.py`` :77,
    :122, :210, :247): the loss, ``moe_aux`` and every gradient, then 3
    train steps."""
    jkw, tkw = EP_CASES[case]
    jcfg = _jcfg(**jkw)
    tcfg = _port_cfg(tt, jcfg, **dict(tkw))
    sizes = dict(data=2, expert=2, tensor=2)
    loss, metrics, grads = _port_grads(tcfg, _params(jcfg),
                                       _batches(jcfg)[0], sizes)
    jloss, jmetrics, jgrads = _jax_case(jcfg, tuple(sizes.items()))
    np.testing.assert_allclose(loss, jloss, rtol=METRIC_RTOL)
    _assert_metrics(metrics, jmetrics)
    _assert_grads(grads, jgrads)
    _steps_match_jax(jcfg, tcfg, _params(jcfg), _batches(jcfg), sizes)


@pytest.mark.parametrize("sizes,jkw", [
    (dict(fsdp=2, expert=2), dict(moe_top_k=2, moe_dropless=True)),
    (dict(expert=2, sequence=2), dict(moe_top_k=2, moe_dropless=True)),
    (dict(expert=2, sequence=2), dict(moe_top_k=2)),
    (dict(data=2, expert=2, sequence=2), dict(moe_top_k=1))],
    ids=["fsdp2-dropless", "seq2-dropless", "seq2-capacity-top2",
         "data2-seq2-capacity-top1"])
def test_expert_axis_composes_with_fsdp_and_sequence(sizes, jkw):
    """``fsdp`` gathers each expert shard's weights; on ``sequence`` the
    dropless work runs per chunk, the capacity dispatch on the joined
    row."""
    jcfg = _jcfg(**jkw)
    tcfg = _port_cfg(tt, jcfg)
    loss, metrics, grads = _port_grads(tcfg, _params(jcfg),
                                       _batches(jcfg)[0], sizes)
    jloss, jmetrics, jgrads = _jax_case(jcfg, tuple(sizes.items()))
    np.testing.assert_allclose(loss, jloss, rtol=METRIC_RTOL)
    _assert_metrics(metrics, jmetrics)
    _assert_grads(grads, jgrads)


def test_expert_mesh_forward_is_the_one_device_forward_bit_for_bit():
    """top-2 dropless with ``tensor=1``: a token's row sums at most two
    nonzero partials, so the expert mesh's loss and aux equal the
    one-device engine's to the bit on the CPU."""
    jcfg = _jcfg(moe_top_k=2, moe_dropless=True)
    tcfg = _port_cfg(tt, jcfg, moe_gmm=True)
    params = _params(jcfg)
    batch = _batches(jcfg)[0]
    loss, metrics, _ = _port_grads(tcfg, params, batch,
                                   dict(data=2, expert=2))
    one = tt.loss_fn(params_from_jax(params, device="cpu"),
                     t_data.to_device(batch, "cpu"), tcfg)[1]
    assert metrics["perplexity"] == float(one["perplexity"])


# ------------------------------------------------------------- pipelines

def _pipe_cfg(**kw):
    """``test_compute_pipeline.py``'s ``_cfg``."""
    base = dict(vocab_size=64, d_model=16, n_layers=4, n_heads=2,
                max_seq=16, dtype="float32", attention="dense", remat=False)
    base.update(kw)
    return jt.Config(**base)


def _pipe_batch(rows, seed=0):
    toks = np.random.default_rng(seed).integers(0, 64, (rows, 16),
                                                dtype=np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def test_capacity_moe_in_gpipe_stages_matches_jax():
    """JAX's ``test_moe_aux_loss_survives_pipelining`` (:259): capacity
    top-1 over 2 experts in 2 stages × 2 microbatches on ``pipeline=2``.
    Perplexity and ``moe_aux`` against JAX's pipelined program (whose aux
    is the mean over layers × microbatches of the global microbatches'),
    and the gradients against ``jax.grad`` of it."""
    jcfg = _pipe_cfg(moe_experts=2, pipeline_stages=2,
                     pipeline_microbatches=2)
    tcfg = _port_cfg(tt, jcfg)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(1)))
    batch = _pipe_batch(4)
    sizes = dict(pipeline=2)
    loss, metrics, grads = _port_grads(tcfg, params, batch, sizes)
    jloss, jmetrics, jgrads = _jax_grads(jcfg, params, batch, sizes)
    np.testing.assert_allclose(metrics["perplexity"], jmetrics["perplexity"],
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["moe_aux"], jmetrics["moe_aux"],
                               rtol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=METRIC_RTOL)
    _assert_grads(grads, jgrads)


def test_dropless_moe_in_gpipe_stages_with_data_and_expert_matches_jax():
    """JAX's ``test_dropless_moe_inside_pipeline`` (:317): dropless top-2
    over 2 experts in 2 stages × 2 microbatches on ``data=2, pipeline=2,
    expert=2``. JAX's microbatch is the GLOBAL rows ``[i·B/M, …)``, so
    its aux groups the rows otherwise than the pieces' own microbatches:
    perplexity and ``moe_aux`` against JAX's pipelined program, the
    gradients against ``jax.grad`` of it."""
    kw = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=2, max_seq=16,
              dtype="float32", attention="dense", remat=False, moe_experts=2,
              moe_top_k=2, moe_dropless=True, pipeline_stages=2,
              pipeline_microbatches=2)
    jcfg = jt.Config(**kw)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = _pipe_batch(8)
    sizes = dict(data=2, pipeline=2, expert=2)
    jloss, jmetrics, jgrads = _jax_grads(jcfg, params, batch, sizes)
    for gmm in (True, False):
        tcfg = _port_cfg(tt, jcfg, moe_gmm=gmm)
        loss, metrics, grads = _port_grads(tcfg, params, batch, sizes)
        np.testing.assert_allclose(metrics["perplexity"],
                                   jmetrics["perplexity"], rtol=1e-5)
        np.testing.assert_allclose(metrics["moe_aux"], jmetrics["moe_aux"],
                                   rtol=1e-5)
        np.testing.assert_allclose(loss, jloss, rtol=METRIC_RTOL)
        _assert_grads(grads, jgrads)
    # the pieces' own microbatches would give another aux
    tcfg = _port_cfg(tt, jcfg)
    own = [tt.loss_fn(params_from_jax(params, device="cpu"),
                      t_data.to_device({k: v[r:r + 4] for k, v in
                                        batch.items()}, "cpu"),
                      tcfg)[1]["moe_aux"] for r in (0, 4)]
    assert abs(float(sum(own)) / 2 - jmetrics["moe_aux"]) > 1e-6


def test_moe_pipeline_mesh_trains_with_copies_equal():
    """3 steps of the dropless pipeline on ``data=2, pipeline=2,
    expert=2`` against JAX's and the port's unsharded one-stage GPipe."""
    jcfg = _pipe_cfg(moe_experts=2, moe_top_k=2, moe_dropless=True,
                     pipeline_stages=2, pipeline_microbatches=2, d_model=32)
    tcfg = _port_cfg(tt, jcfg)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    batches = [_pipe_batch(8, seed) for seed in range(STEPS)]
    _steps_match_jax(jcfg, tcfg, params, batches,
                     dict(data=2, pipeline=2, expert=2))


# ------------------------------------------------ the aux is the global

def test_skewed_routing_takes_the_global_aux():
    """``data=2`` with each piece's rows one repeated token, the two
    tokens routed apart: every position of a row routes alike, so the
    pieces' routing fractions differ and the mean of their aux values
    leaves the global aux by more than 1e-3. The mesh's aux is JAX's
    global one within 1e-6. (A row of one token gives ``wk`` no
    gradient — attention averages equal values whatever the scores — so
    its leaf holds rounding noise on both sides: the gradients are held
    to the model's max |g|.)"""
    jcfg = _jcfg(moe_top_k=2, moe_dropless=True)
    tcfg = _port_cfg(tt, jcfg)
    params = {**_params(jcfg)}
    layers = dict(params["layers"])
    layers["router"] = layers["router"] * 8.0     # sharper routing
    params["layers"] = layers
    tparams = params_from_jax(params, device="cpu")

    def one_device_aux(tok):
        toks = np.full((4, jcfg.max_seq), tok, np.int32)
        return float(tt.loss_fn(tparams, t_data.to_device(
            {"tokens": toks, "targets": toks}, "cpu"), tcfg)[1]["moe_aux"])

    def batch_of(a, b):
        toks = np.concatenate([np.full((4, jcfg.max_seq), a, np.int32),
                               np.full((4, jcfg.max_seq), b, np.int32)])
        return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}

    pair, gap = None, 0.0
    for b in range(1, 40):
        whole = float(tt.loss_fn(tparams, t_data.to_device(
            batch_of(0, b), "cpu"), tcfg)[1]["moe_aux"])
        gap = abs(whole - (one_device_aux(0) + one_device_aux(b)) / 2)
        if gap > 1e-2:
            pair = (0, b)
            break
    assert pair is not None, gap
    batch = batch_of(*pair)
    sizes = dict(data=2)
    _, metrics, grads = _port_grads(tcfg, params, batch, sizes)
    _, jmetrics, jgrads = _jax_grads(jcfg, params, batch, sizes)
    _assert_metrics(metrics, jmetrics)
    _assert_grads(grads, jgrads, whole_model=True)
    mean_of_pieces = (one_device_aux(pair[0]) + one_device_aux(pair[1])) / 2
    assert abs(mean_of_pieces - jmetrics["moe_aux"]) > 1e-3
    assert abs(metrics["moe_aux"] - mean_of_pieces) > 1e-3


# ------------------------------------------- checkpoints and refusals

def test_checkpoint_from_an_expert_mesh_restores_onto_one_device(tmp_path):
    jcfg = _jcfg(moe_top_k=2, moe_dropless=True)
    tcfg = _port_cfg(tt, jcfg)
    _, mesh = _meshes(data=2, expert=2, tensor=2)
    opt = t_train.make_optimizer(1e-2, warmup_steps=1, total_steps=20)
    state = t_train.init_state(
        lambda g, device: params_from_jax(_params(jcfg), device=device), opt,
        mesh=mesh, logical_axes=tt.logical_axes(tcfg))
    step = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, tcfg), opt,
                                   mesh=mesh)
    state, _ = _run(step, state, _batches(jcfg))
    leaf = state.params["layers"]["we_gate"]
    assert leaf.spec == (None, "expert", "fsdp", "tensor")
    assert leaf.pieces[0].shape == (2, 2, 32, tcfg.ff_dim // 2)
    ckpt = t_ckpt.Checkpointer(tmp_path / "ep", async_save=False)
    assert ckpt.save(state)
    single = t_train.init_state(
        functools.partial(tt.init_params, tcfg),
        t_train.make_optimizer(1e-2, warmup_steps=1, total_steps=20),
        device="cpu")
    restored = t_ckpt.Checkpointer(tmp_path / "ep").restore(single)
    assert restored.step == STEPS
    for a, b in zip(t_train.tree_leaves(restored.params),
                    t_train.tree_leaves(t_train.gather_params(state))):
        assert torch.is_tensor(a) and torch.equal(a.detach(), b)
    for a, b in zip(t_train.tree_leaves(restored.opt_state["mu"]),
                    t_train.tree_leaves(t_sharding.gather_tree(
                        state.opt_state["mu"]))):
        assert torch.equal(a, b)
    # the restored one-device state takes the step the mesh takes
    batch = _batches(jcfg, n=1)[0]
    _, um = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, tcfg),
                                    t_train.make_optimizer(
                                        1e-2, warmup_steps=1,
                                        total_steps=20))(
        restored, t_data.to_device(batch, "cpu"))
    _, mm = step(state, batch)
    np.testing.assert_allclose(float(um["loss"]), float(mm["loss"]),
                               rtol=METRIC_RTOL)


def test_experts_must_divide_over_the_expert_axis():
    jcfg = _jcfg(moe_experts=3, moe_top_k=2, moe_dropless=True)
    tcfg = _port_cfg(tt, jcfg)
    _, mesh = _meshes(data=2, expert=2)
    with pytest.raises(ValueError, match="moe_experts=3 does not divide "
                                         "over the mesh's expert axis of 2"):
        tt._check_mesh(tcfg, mesh)
    # placement names the leaf first
    with pytest.raises(ValueError, match="layers/we_gate: dim 1 of size 3"):
        t_train.init_state(functools.partial(tt.init_params, tcfg),
                           t_train.make_optimizer(), mesh=mesh,
                           logical_axes=tt.logical_axes(tcfg))


# ----------------------------------- models without experts on the axis

def test_dense_transformer_runs_replicated_over_expert():
    """A dense model on ``expert=2``: each expert coordinate a copy, as
    in JAX (3 steps against JAX's)."""
    jcfg = _jcfg(moe_experts=0)
    tcfg = _port_cfg(tt, jcfg)
    batches = _batches(jcfg)
    for b in batches:
        b["mask"] = (np.random.default_rng(4).random(b["tokens"].shape)
                     < 0.8).astype(np.float32)
    params = _params(jcfg)
    _parity(j_train.plain_loss(jt.loss_fn, jcfg),
            t_train.plain_loss(tt.loss_fn, tcfg),
            lambda k: jax.tree.map(jnp.asarray, params),
            lambda g, device: params_from_jax(params, device=device),
            jt.logical_axes(jcfg), tt.logical_axes(tcfg), batches,
            dict(data=2, expert=2, tensor=2))


def test_mlp_and_bert_run_replicated_over_expert():
    """The MLP and BERT name no expert axis: on ``expert=2`` every expert
    coordinate holds copies the forward does not read, which take the
    sum of the others (3 steps each against JAX's)."""
    jcfg, tcfg, params, batches = _mlp_case(8, in_dim=16, hidden=8)
    _parity(j_train.plain_loss(jm.loss_fn, jcfg),
            t_train.plain_loss(tm.loss_fn, tcfg),
            lambda k: jax.tree.map(jnp.asarray, params),
            lambda g, device: tree_from_jax(params, device=device),
            jm.logical_axes(jcfg), tm.logical_axes(tcfg), batches,
            dict(data=2, expert=2))
    jcfg = jb.Config(vocab_size=256, d_model=32, n_layers=1, n_heads=2,
                     d_ff=64, max_seq=16, dtype="float32", attention="dense",
                     remat=False)
    tcfg = _port_cfg(tb, jcfg)
    params = _np(jb.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    _parity(j_train.plain_loss(jb.loss_fn, jcfg),
            t_train.plain_loss(tb.loss_fn, tcfg),
            lambda k: jax.tree.map(jnp.asarray, params),
            lambda g, device: tree_from_jax(params, device=device),
            jb.logical_axes(jcfg), tb.logical_axes(tcfg),
            [tb.mlm_batch(rng, 4, tcfg) for _ in range(STEPS)],
            dict(data=2, expert=2), whole_model=True, noise=("bk",))

