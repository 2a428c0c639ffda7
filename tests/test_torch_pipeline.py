"""The port's pipeline schedules (``compute/pipeline.py``) and the
``pipeline`` axis of its training mesh, against the JAX package's
(``tests/test_compute_pipeline.py``), on the CPU in fp32.

JAX runs on ``jax.devices()[:n]`` of the forced 8-device CPU mesh, the
port on ``["cpu"] * n`` with the same axis sizes; weights and batches
are the same numpy arrays. GPipe is an execution order, not another
function: the pipelined loss and gradients are JAX's pipelined ones
(loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, as JAX's tests hold
them). 1F1B's loss and gradients are held to JAX's ``train_1f1b`` the
same way.

JAX compares 1F1B's memory with GPipe's through the compiler's memory
analysis; the port has no compiler, so it counts instead: the schedule's
high-water mark of stage inputs (``train_1f1b.live_inputs``, at most
``2P - 1`` whatever M is) and the bytes autograd keeps for the backward
(``saved_tensors_hooks``), which grow with M under GPipe and stay flat
under 1F1B.
"""

import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import pipeline as j_pipeline
from kubeflow_tpu.compute import sharding as j_sharding
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import checkpoint as t_ckpt
from kubeflow_tpu_torch.compute import data as t_data
from kubeflow_tpu_torch.compute import mesh as t_mesh
from kubeflow_tpu_torch.compute import pipeline as t_pipeline
from kubeflow_tpu_torch.compute import sharding as t_sharding
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax
from test_torch_pipeline_gang import D, L, S, V
from test_torch_pipeline_gang import toy_data as _toy_data
from test_torch_pipeline_gang import toy_fns as _t_fns
from test_torch_ring import (assert_loss_and_grads, jax_loss_and_grads,
                             port_loss_and_grads)
from test_torch_train_mesh import (_assert_copies_equal, _lm_batches,
                                   _meshes, _np, _parity, _port_cfg,
                                   _same_state)


def _cfgs(**kw):
    """``test_compute_pipeline.py``'s ``_cfg``."""
    base = dict(vocab_size=64, d_model=16, n_layers=4, n_heads=2,
                max_seq=16, dtype="float32", attention="dense", remat=False)
    base.update(kw)
    jcfg = jt.Config(**base)
    return jcfg, _port_cfg(tt, jcfg)


def _batch(batch=4, seed=0, vocab=64, seq=16):
    toks = np.random.default_rng(seed).integers(0, vocab, (batch, seq),
                                                dtype=np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


@pytest.fixture(scope="module")
def lm_params():
    return _np(jt.init_params(_cfgs()[0], jax.random.PRNGKey(1)))


# -------------------------------------------------------------- GPipe

@pytest.mark.parametrize("stages,micro,rows", [(2, 2, 4), (2, 4, 8),
                                               (4, 4, 4)],
                         ids=["2x2", "2x4", "4x4"])
def test_gpipe_matches_jax(lm_params, stages, micro, rows):
    """``TestPipelineMatchesScan``: 2 stages / 2 microbatches, 2 / 4 and
    4 / 4, each on a ``pipeline`` mesh of its stages."""
    jcfg, tcfg = _cfgs(pipeline_stages=stages,
                       pipeline_microbatches=micro)
    batch = _batch(rows)
    sizes = dict(pipeline=stages)
    assert_loss_and_grads(port_loss_and_grads(tcfg, lm_params, batch, sizes),
                          jax_loss_and_grads(jcfg, lm_params, batch, sizes))


def test_stages_on_one_device_match_jax(lm_params):
    """``pipeline_stages=2`` without a mesh: one stage of 4 layers over 2
    microbatches, as JAX's pipeline on a one-device mesh."""
    jcfg, tcfg = _cfgs(pipeline_stages=2)
    batch = _batch(4)
    want = jax_loss_and_grads(jcfg, lm_params, batch, {})
    params = params_from_jax(lm_params, device="cpu")
    leaves = t_train.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tt.loss_fn(params, t_data.to_device(batch, "cpu"), tcfg)
    assert_loss_and_grads((float(loss.detach()),
                           t_train._grads(loss, leaves)), want)


def test_replicated_pipeline_without_stages_matches_jax(lm_params):
    """A ``pipeline=2`` mesh with ``pipeline_stages=0``: the layers are
    replicated over the axis, the piece runs once (pipeline coordinate
    0) and the copy sum hands both copies its gradient — JAX's loss and
    gradients, and 3 of its train steps' metrics and params."""
    jcfg, tcfg = _cfgs()
    sizes = dict(data=2, pipeline=2)
    batch = _batch(4)
    assert_loss_and_grads(port_loss_and_grads(tcfg, lm_params, batch, sizes),
                          jax_loss_and_grads(jcfg, lm_params, batch, sizes))
    jcfg = jt.Config(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                     max_seq=32, dtype="float32", attention="dense",
                     remat=False)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(2)))
    _, mstate, _ = _parity(
        j_train.plain_loss(jt.loss_fn, jcfg),
        t_train.plain_loss(tt.loss_fn, _port_cfg(tt, jcfg)),
        lambda k: jax.tree.map(jnp.asarray, params),
        lambda g, device: params_from_jax(params, device=device),
        jt.logical_axes(jcfg), tt.logical_axes(_port_cfg(tt, jcfg)),
        _lm_batches(), sizes)
    _assert_copies_equal(mstate)


def test_ring_inside_pipelined_stages_matches_jax(lm_params):
    """``sequence=2, pipeline=2`` with ``attention="ring"`` and two
    stages: each stage's chunks ride the ring between the stages' hops.
    The loss is JAX's forward on that mesh. JAX's backward through its
    ring nested in the pipeline's ``shard_map`` does not lower on this
    toolchain (the verifier refuses a manual axis bound twice), so the
    gradients are held to JAX's ring on ``sequence=2`` without stages:
    GPipe is an execution order, the same function."""
    jcfg, tcfg = _cfgs(pipeline_stages=2, attention="ring", remat=True)
    sizes = dict(pipeline=2, sequence=2)
    batch = _batch(4, seed=3)
    jmesh = _meshes(**sizes)[0]
    placed = j_sharding.shard_tree(jax.tree.map(jnp.asarray, lm_params),
                                   jmesh, jt.logical_axes(jcfg))
    with jax.set_mesh(jmesh):
        jloss = jax.jit(lambda p: jt.loss_fn(
            p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(placed)
    got = port_loss_and_grads(tcfg, lm_params, batch, sizes)
    flat, _ = _cfgs(attention="ring", remat=True)
    want = jax_loss_and_grads(flat, lm_params, batch, dict(sequence=2))
    np.testing.assert_allclose(want[0], float(jloss), rtol=1e-5)
    assert_loss_and_grads(got, want)


def test_trains_with_data_and_tensor_axes():
    """``test_trains_with_data_and_tensor_axes``: 3 steps of JAX's
    pipelined train step and the port's on data=2, pipeline=2,
    tensor=2 (2 stages, 2 microbatches, GQA 4:2, masks), and of the
    port's unsharded step."""
    jcfg = jt.Config(vocab_size=128, d_model=64, n_layers=4, n_heads=4,
                     n_kv_heads=2, max_seq=32, dtype="float32",
                     attention="dense", remat=False, pipeline_stages=2,
                     pipeline_microbatches=2)
    tcfg = _port_cfg(tt, jcfg)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    _, mstate, _ = _parity(
        j_train.plain_loss(jt.loss_fn, jcfg),
        t_train.plain_loss(tt.loss_fn, tcfg),
        lambda k: jax.tree.map(jnp.asarray, params),
        lambda g, device: params_from_jax(params, device=device),
        jt.logical_axes(jcfg), tt.logical_axes(tcfg), _lm_batches(),
        dict(data=2, pipeline=2, tensor=2))
    _assert_copies_equal(mstate)


def test_stage_dim_is_placed_over_the_pipeline_axis(lm_params):
    """The stacked-layer dim leads with ``"stage"`` → ``pipeline``: stage
    s's positions hold layers ``[s·L/P, (s+1)·L/P)``, the pieces JAX's
    ``NamedSharding`` puts on the same positions."""
    jcfg, tcfg = _cfgs(pipeline_stages=2)
    jmesh, tmesh = _meshes(pipeline=2)
    assert tt.logical_axes(tcfg) == jt.logical_axes(jcfg)
    spec = t_sharding.tree_shardings(
        tmesh, tt.logical_axes(tcfg))["layers"]["wq"].spec
    assert spec[0] == "pipeline"
    jplaced = j_sharding.shard_tree(jax.tree.map(jnp.asarray, lm_params),
                                    jmesh, jt.logical_axes(jcfg))
    tplaced = t_sharding.place_tree(params_from_jax(lm_params, device="cpu"),
                                    tmesh, tt.logical_axes(tcfg))
    for name, leaf in tplaced["layers"].items():
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in jplaced["layers"][name].addressable_shards}
        for p, dev in enumerate(jmesh.devices.reshape(-1)):
            assert leaf.pieces[p].shape[0] == 2
            np.testing.assert_array_equal(leaf.pieces[p].numpy(),
                                          by_dev[dev.id])


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("case", ["layers", "scan_layers", "microbatches"])
def test_pipeline_refusals(case):
    """``TestPipelineValidation``: JAX's texts."""
    if case == "layers":
        with pytest.raises(ValueError, match="n_layers=3 not divisible by "
                                             "pipeline_stages=2"):
            _cfgs(n_layers=3, pipeline_stages=2)
    elif case == "scan_layers":
        with pytest.raises(ValueError, match="scan_layers"):
            _cfgs(scan_layers=False, pipeline_stages=2)
    else:
        _, tcfg = _cfgs(pipeline_stages=2, pipeline_microbatches=3)
        with pytest.raises(ValueError, match="batch 4 not divisible by "
                                             "n_microbatches=3"):
            port_loss_and_grads(tcfg, _np(jt.init_params(
                _cfgs()[0], jax.random.PRNGKey(1))), _batch(4),
                dict(pipeline=2))


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_moe_in_a_pipeline_waits_for_expert_parallelism(dropless):
    """JAX's two MoE-in-pipeline configs on ``pipeline=2`` (the expert
    parallelism has come): 2 stages × 2 microbatches of an MoE give the
    loss and gradients of the one-device one-stage GPipe over the same
    microbatches, whose aux groups the same global rows."""
    jcfg, tcfg = _cfgs(moe_experts=2, pipeline_stages=2,
                       pipeline_microbatches=2, moe_dropless=dropless,
                       moe_top_k=2 if dropless else 1)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(1)))
    batch = _batch(4)
    loss, grads = port_loss_and_grads(tcfg, params, batch, dict(pipeline=2))
    tparams = params_from_jax(params, device="cpu")
    leaves = t_train.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    one, metrics = tt.loss_fn(tparams, t_data.to_device(batch, "cpu"), tcfg)
    assert "moe_aux" in metrics
    assert_loss_and_grads((loss, grads), (float(one.detach()), [
        g.numpy() for g in t_train._grads(one, leaves)]))


# ---------------------------------------------------------------- 1F1B


def _toy_params(seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return jax.tree.map(np.array, {
        "embed": {"emb": jax.random.normal(ks[0], (V, D)) * 0.3},
        "layers": {"w": jax.random.normal(ks[1], (L, D, D)) * 0.3},
        "head": {"out": jax.random.normal(ks[2], (D, V)) * 0.3}})


def _j_fns(aux=None):
    """JAX's twin of ``toy_fns(aux)``: the aux ``mean(x²)`` for
    ``"square"``, ``mean(x)²`` over the whole microbatch for ``"row"``."""
    def embed(ep, tok):
        return ep["emb"][tok]

    def layer(lp, x):
        y = x + jnp.tanh(x @ lp["w"])
        if aux == "square":
            return y, jnp.mean(x ** 2)
        if aux == "row":
            return y, jnp.mean(x) ** 2
        return y, jnp.float32(0.0)

    def loss(hp, y, tgt):
        logits = y @ hp["out"]
        logz = jax.nn.logsumexp(logits, axis=-1)
        lab = jnp.take_along_axis(logits, tgt[..., None], -1)[..., 0]
        return jnp.mean(logz - lab)

    return embed, layer, loss


@pytest.mark.parametrize("stages,micro,rows,aux", [
    (2, 4, 8, 0.0), (4, 8, 16, 0.0), (2, 4, 8, 0.3)],
    ids=["2x4", "4x8", "aux"])
def test_1f1b_matches_jax(stages, micro, rows, aux):
    """``Test1F1B``'s three parity tests: 2 stages / 4 microbatches, 4 /
    8, and the per-layer aux joining the objective with its gradients
    (``aux_weight`` 0.3). Plain params in, logical grads out."""
    params = _toy_params(seed=5 if stages == 4 else 0)
    tok, tgt = _toy_data(rows, seed=6 if stages == 4 else 3)
    jmesh, tmesh = _meshes(pipeline=stages)
    with jax.set_mesh(jmesh):
        jloss, jgrads = jax.jit(lambda p: j_pipeline.train_1f1b(
            *_j_fns("square" if aux else None), p, tok, tgt,
            n_microbatches=micro,
            aux_weight=aux))(jax.tree.map(jnp.asarray, params))
    loss, grads = t_pipeline.train_1f1b(
        *_t_fns("square" if aux else None),
        t_train.tree_map(torch.from_numpy, params),
        torch.from_numpy(tok), torch.from_numpy(tgt), micro, tmesh,
        aux_weight=aux)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, w in zip(t_train.tree_leaves(grads),
                    jax.tree.leaves(_np(jgrads))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)
    assert t_pipeline.train_1f1b.live_inputs <= 2 * stages - 1


def test_1f1b_grads_keep_a_placed_layout():
    """``Sharded`` params in: the layer grads come back cut over
    ``pipeline`` and every copy of the embedding and head holds the
    whole gradient (the psum); gathered, they are the plain call's."""
    params = _toy_params()
    tok, tgt = (torch.from_numpy(x) for x in _toy_data(8))
    _, tmesh = _meshes(pipeline=2)
    plain = t_train.tree_map(torch.from_numpy, params)
    logical = {"embed": {"emb": None}, "layers": {"w": ("stage",)},
               "head": {"out": None}}
    placed = t_sharding.place_tree(plain, tmesh, logical)
    loss_p, grads_p = t_pipeline.train_1f1b(*_t_fns(), placed, tok,
                                            tgt, 4, tmesh)
    loss, grads = t_pipeline.train_1f1b(*_t_fns(), plain, tok, tgt, 4,
                                        tmesh)
    assert torch.equal(loss_p, loss)
    w = grads_p["layers"]["w"]
    assert w.spec == ("pipeline",) and w.pieces[0].shape == (2, D, D)
    emb = grads_p["embed"]["emb"]
    assert torch.equal(emb.pieces[0], emb.pieces[1])
    for a, b in zip(t_train.tree_leaves(t_sharding.gather_tree(grads_p)),
                    t_train.tree_leaves(grads)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="batch 8 not divisible by "
                                         "n_microbatches=3"):
        t_pipeline.train_1f1b(*_t_fns(), plain, tok, tgt, 3, tmesh)
    # the named refusals: an uneven cut over a gang's data axis (8 rows
    # a process, 16 in all, 1 a microbatch), and over one process's
    gang = t_mesh.Mesh(["cpu"] * 2, {**tmesh.shape}, process_count=2)
    with pytest.raises(ValueError, match="a microbatch of 1 rows does not "
                                         "divide over the mesh's 'data' "
                                         r"axis of 2 \(1 on each of 2 "
                                         r"processes\)"):
        t_pipeline.train_1f1b(*_t_fns(), plain, tok, tgt, 16, gang)
    with pytest.raises(ValueError, match="a microbatch of 1 rows does not "
                                         "divide over the mesh's 'data' "
                                         "axis of 2"):
        t_pipeline.train_1f1b(*_t_fns(), plain, tok, tgt, 8,
                              _meshes(pipeline=2, data=2)[1])


@pytest.mark.parametrize("axes,micro,rows,aux", [
    (dict(data=2, pipeline=2), 4, 8, None),
    (dict(data=2, pipeline=2), 4, 8, "square"),
    (dict(data=2, pipeline=2, tensor=2), 4, 8, "square"),
    (dict(data=2, pipeline=2), 4, 8, "row")],
    ids=["data2x4", "data_aux", "data_tensor", "data_row_aux"])
def test_1f1b_beside_other_axes_matches_jax(axes, micro, rows, aux):
    """``train_1f1b`` on ``data × pipeline`` (each microbatch cut over
    ``data``, the loss on the joined microbatch; the plain aux
    ``mean(x²)`` the cuts' mean, the non-linear ``(mean x)²`` in row
    form, ``aux_weight`` 0.3) and with the toy ``w`` placed over
    ``tensor`` too (gathered whole at each stage's lead, its gradient
    cut back into that layout) against JAX's ``jax.jit(train_1f1b)`` on
    the same mesh, whose other axes XLA partitions: loss rtol 1e-5,
    gradients rtol 1e-4 / atol 1e-6. With ``(mean x)²`` as a plain aux
    (each cut's ``finish`` of its own ``stats``: the mean of the cuts'
    squares, the rule before the row form) the loss lies more than 1e-5
    off JAX's (7.0e-5 relative, and the embedding gradient 1.5e-3 of its
    max |g|): the case tells the two apart."""
    params = _toy_params()
    tok, tgt = _toy_data(rows)
    jmesh, tmesh = _meshes(**axes)
    layout = ("pipeline", None, "tensor") if "tensor" in axes else \
        ("pipeline",)
    jparams = jax.tree.map(jnp.asarray, params)
    jparams["layers"]["w"] = jax.device_put(
        jparams["layers"]["w"],
        jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(
            *layout)))
    with jax.set_mesh(jmesh):
        jloss, jgrads = jax.jit(lambda p: j_pipeline.train_1f1b(
            *_j_fns(aux), p, tok, tgt, n_microbatches=micro,
            aux_weight=0.3 if aux else 0.0))(jparams)
    plain = t_train.tree_map(torch.from_numpy, params)
    placed = {"embed": t_sharding.place_tree(plain["embed"], tmesh),
              "layers": {"w": t_sharding.place(plain["layers"]["w"], layout,
                                               tmesh)},
              "head": t_sharding.place_tree(plain["head"], tmesh)}
    loss, grads = t_pipeline.train_1f1b(
        *_t_fns(aux), placed, torch.from_numpy(tok),
        torch.from_numpy(tgt), micro, tmesh, aux_weight=0.3 if aux else 0.0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    w = grads["layers"]["w"]
    assert w.spec == layout
    assert w.pieces[0].shape == ((2, D, D // 2) if "tensor" in axes
                                 else (2, D, D))
    for leaf in t_train.tree_leaves(grads):
        for group in leaf.sharding.copies:
            for q in group[1:]:
                assert torch.equal(leaf.pieces[q], leaf.pieces[group[0]])
    for g, want in zip(t_train.tree_leaves(t_sharding.gather_tree(grads)),
                       jax.tree.leaves(_np(jgrads))):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6)
    assert t_pipeline.train_1f1b.live_inputs <= 2 * 2 - 1
    if aux == "row":
        embed, layer, loss_fn = _t_fns(aux)

        def plain(lp, x):
            y, row = layer(lp, x)
            return y, row.finish(row.stats, x.shape[0])

        cut_mean, _ = t_pipeline.train_1f1b(
            embed, plain, loss_fn, placed, torch.from_numpy(tok),
            torch.from_numpy(tgt), micro, tmesh, aux_weight=0.3)
        assert abs(float(cut_mean) - float(jloss)) > 1e-5 * abs(float(jloss))


def _lm_fns(cfg, row_aux=True):
    """The port's transformer as ``train_1f1b``'s functions (one layer
    each ``layer_fn``, the MoE aux in row form with ``row_aux``; the
    head a plain cross-entropy mean) and JAX's twin."""
    def embed(ep, tok):
        return ep["embed"][tok.long()]

    def layer(lp, x):
        rope = tt.rope_tables(cfg[1], torch.arange(x.shape[1]))
        return tt._layer(tt.flat_layer(lp), x, rope, cfg[1],
                         row_aux=row_aux)

    def loss(hp, y, tgt):
        logits = tt._logits(tt._rmsnorm(y, hp["final_norm"]), hp["head"])
        lab = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - lab).mean()

    def j_embed(ep, tok):
        return ep["embed"][tok]

    def j_layer(lp, x):
        rope = jt.rope_tables(cfg[0], jnp.arange(x.shape[1]))
        return jt._layer(lp, x, rope, cfg[0])

    def j_loss(hp, y, tgt):
        logits = jt._logits(jt._rmsnorm(y, hp["final_norm"]), hp["head"])
        lab = jnp.take_along_axis(logits, tgt[..., None], -1)[..., 0]
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - lab)

    return (embed, layer, loss), (j_embed, j_layer, j_loss)


def test_1f1b_moe_aux_over_data_matches():
    """A 2-layer MoE (2 experts, top-1, dropless on the plain ragged
    engine) through ``train_1f1b`` with ``aux_weight`` 0.3, 8 rows in 4
    microbatches. On ``data=2 × pipeline=2`` each layer gives its
    load-balancing aux in row form (``_moe_row_aux``), so a microbatch
    cut in two gets the whole microbatch's aux: loss rtol 1e-5 and
    gradients rtol 1e-4 / atol 1e-6 against the port's ``pipeline=2``
    1F1B, where no microbatch is cut, and against JAX's MoE layer
    through ``jax.jit(train_1f1b)`` on ``data=2 × pipeline=2``. The
    plain aux there (the mean of the cuts' values) lies more than 1e-5
    off: the case tells the two apart."""
    cfg = _cfgs(n_layers=2, moe_experts=2, moe_top_k=1, moe_dropless=True,
                moe_gmm=False)
    params = jax.tree.map(np.array, jt.init_params(cfg[0],
                                                   jax.random.PRNGKey(4)))
    tree = {"embed": {"embed": params["embed"]}, "layers": params["layers"],
            "head": {"final_norm": params["final_norm"],
                     "head": params["head"]}}
    tok = np.random.default_rng(8).integers(0, 64, (8, 16), dtype=np.int32)
    tgt = np.roll(tok, -1, axis=1)
    fns, j_fns = _lm_fns(cfg)
    jmesh, data_mesh = _meshes(data=2, pipeline=2)
    with jax.set_mesh(jmesh):
        jloss, jgrads = jax.jit(lambda p: j_pipeline.train_1f1b(
            *j_fns, p, tok, tgt, n_microbatches=4, aux_weight=0.3))(
                jax.tree.map(jnp.asarray, tree))
    want = (float(jloss), jax.tree.leaves(_np(jgrads)))

    def port(fns, mesh):
        loss, grads = t_pipeline.train_1f1b(
            *fns, t_train.tree_map(torch.from_numpy, tree),
            torch.from_numpy(tok), torch.from_numpy(tgt), 4, mesh,
            aux_weight=0.3)
        return float(loss), [g.numpy() for g in t_train.tree_leaves(grads)]

    on_data = port(fns, data_mesh)
    pipe_only = port(fns, _meshes(pipeline=2)[1])
    for ref in (pipe_only, want):
        np.testing.assert_allclose(on_data[0], ref[0], rtol=1e-5)
        assert len(on_data[1]) == len(ref[1]) == 13
        for g, w in zip(on_data[1], ref[1]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    plain = port(_lm_fns(cfg, row_aux=False)[0], data_mesh)
    assert abs(plain[0] - want[0]) > 1e-5 * abs(want[0])


class _Box:
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


class _Saved:
    """The bytes autograd keeps for the backward that are live at once:
    every tensor a graph saves (``saved_tensors_hooks``) that is not a
    leaf (the parameters and the inputs are alive anyway), counted once
    per storage until autograd drops its last reference."""

    def __init__(self):
        self.now = self.peak = 0
        self.refs = {}

    def pack(self, t):
        box = _Box(t)
        if t.is_leaf:
            return box
        key = t.untyped_storage().data_ptr()
        if key not in self.refs:
            self.refs[key] = 0
            self.now += t.untyped_storage().nbytes()
            self.peak = max(self.peak, self.now)
        self.refs[key] += 1
        weakref.finalize(box, self._drop, key, t.untyped_storage().nbytes())
        return box

    def _drop(self, key, nbytes):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.now -= nbytes

    @staticmethod
    def unpack(box):
        return box.t


def _gpipe(params, tok, tgt, micro):
    """GPipe over 2 stages of the toy model under autograd → (loss,
    peak saved bytes)."""
    embed, layer, loss_fn = _t_fns()
    p = t_train.tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                         params)
    stages = [[{"w": p["layers"]["w"][i]} for i in range(s * 2, s * 2 + 2)]
              for s in range(2)]
    saved = _Saved()
    with torch.autograd.graph.saved_tensors_hooks(saved.pack, saved.unpack):
        y, _ = t_pipeline.pipelined_layers(layer, stages,
                                           embed(p["embed"], tok), micro)
        loss = loss_fn(p["head"], y, tgt)
    peak = saved.peak
    torch.autograd.grad(loss, t_train.tree_leaves(p))
    return loss.detach(), peak


def test_1f1b_live_inputs_stay_within_the_depth():
    """Microbatches of 4 rows, M = 4, 8 and 16 over 2 stages: 1F1B holds
    at most 2P - 1 = 3 stage inputs a stage and its saved activations
    stay flat, while GPipe keeps every microbatch's activations until
    the backward, so its saved bytes grow with M. At M = 16 GPipe keeps
    more than 1F1B's saved bytes plus its live inputs; the losses agree
    (rtol 1e-5)."""
    params = _toy_params()
    _, tmesh = _meshes(pipeline=2)
    rows = {}
    for micro in (4, 8, 16):
        tok, tgt = (torch.from_numpy(x) for x in _toy_data(4 * micro))
        saved = _Saved()
        with torch.autograd.graph.saved_tensors_hooks(saved.pack,
                                                      saved.unpack):
            loss, _ = t_pipeline.train_1f1b(
                *_t_fns(), t_train.tree_map(torch.from_numpy, params),
                tok, tgt, micro, tmesh)
        live = t_pipeline.train_1f1b.live_inputs
        g_loss, g_peak = _gpipe(params, tok, tgt, micro)
        np.testing.assert_allclose(float(loss), float(g_loss), rtol=1e-5)
        rows[micro] = (live, saved.peak, g_peak)
    assert all(live <= 3 for live, _, _ in rows.values())
    assert len({f1b for _, f1b, _ in rows.values()}) == 1
    assert rows[4][2] < rows[8][2] < rows[16][2]
    input_bytes = 4 * S * D * 4
    live, f1b, gpipe = rows[16]
    assert f1b + live * input_bytes < gpipe


# ---------------------------------------------------------- checkpoints

def _staged_state(mesh, seed, stages):
    _, tcfg = _cfgs(pipeline_stages=stages)
    opt = t_train.make_optimizer(1e-2, warmup_steps=1, total_steps=20)
    where = dict(device="cpu") if mesh is None else dict(
        mesh=mesh, logical_axes=tt.logical_axes(tcfg))
    return tcfg, opt, t_train.init_state(
        functools.partial(tt.init_params, tcfg), opt,
        generator=torch.Generator().manual_seed(seed), **where)


def test_checkpoint_crosses_pipeline_and_sequence_meshes(tmp_path):
    """A state trained 2 steps on a two-stage ``pipeline=2`` mesh,
    saved, restores onto one device and onto a ``sequence=2`` mesh; a
    state saved on ``sequence=2`` restores onto ``pipeline=2``, stage
    cut and all."""
    _, pipe = _meshes(pipeline=2)
    _, seq = _meshes(sequence=2)
    cfg, opt, state = _staged_state(pipe, 0, 2)
    step = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, cfg), opt,
                                   mesh=pipe)
    for _ in range(2):
        state, _ = step(state, _batch(4))
    ckpt = t_ckpt.Checkpointer(tmp_path / "pipe", async_save=False)
    ckpt.save(state)
    ckpt.close()
    restored = t_ckpt.Checkpointer(tmp_path / "pipe").restore(
        _staged_state(None, 5, 2)[2])
    for a, b in zip(t_train.tree_leaves(restored.params),
                    t_train.tree_leaves(t_train.gather_params(state))):
        assert torch.is_tensor(a) and torch.equal(a.detach(), b)
    onto_seq = t_ckpt.Checkpointer(tmp_path / "pipe").restore(
        _staged_state(seq, 6, 0)[2])
    _same_state(onto_seq, state)
    assert onto_seq.params["layers"]["wq"].mesh is seq
    ckpt = t_ckpt.Checkpointer(tmp_path / "seq", async_save=False)
    ckpt.save(onto_seq)
    ckpt.close()
    back = t_ckpt.Checkpointer(tmp_path / "seq").restore(
        _staged_state(pipe, 7, 2)[2])
    _same_state(back, state)
    wq = back.params["layers"]["wq"]
    assert wq.spec[0] == "pipeline" and wq.pieces[1].shape[0] == 2
    for a, b in zip(wq.pieces, state.params["layers"]["wq"].pieces):
        assert torch.equal(a, b)
