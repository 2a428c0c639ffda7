"""The port's ResNet against the JAX package's, on the CPU in fp32.

Weights and batch statistics come from JAX ``init_params`` (perturbed
with numpy noise so that no BN scale is zero and no statistic trivial)
and cross through ``tree_from_jax``; images are numpy from a seed.
Narrow models (``width=8``) at 32 px, and odd-sized planes, where XLA's
asymmetric ``"SAME"`` padding of the stride-2 convs and of the max pool
shows.

Tolerances, with their reasons:

- logits, new batch statistics, block outputs: 1e-4 absolute on values
  of order 1 (fp32 reduction order; the one-pass variance E[x²] − E[x]²
  cancels, which amplifies last-bit differences of the two sums);
- every gradient leaf: max |Δ| ≤ 1e-4 × that leaf's max |g|;
- params after 3 optimizer steps: as ``test_torch_train.py`` — within
  1e-6, or within 2·lr per nonzero-rate update for at most 0.1 % of
  the model's elements (Adam's sign flips at near-zero gradients);
  batch statistics within 1e-4 after the first step and within those
  2·lr per update after the third.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import resnet as jr
from kubeflow_tpu_torch.compute import checkpoint as t_ckpt
from kubeflow_tpu_torch.compute import data as t_data
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import resnet as tr
from kubeflow_tpu_torch.compute.params import (params_to_numpy,
                                               tree_from_jax)

LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(depth, **kw):
    fields = dict(depth=depth, width=8, dtype="float32", n_classes=10)
    fields.update(kw)
    return jr.Config(**fields), tr.Config(**fields)


@functools.lru_cache(maxsize=None)
def _weights(depth):
    """JAX's init, every leaf perturbed (so the zero-initialised last BN
    scales and the unit statistics become generic), as numpy trees."""
    jcfg, _ = _cfgs(depth)
    params, stats = _np(jr.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(depth)

    def noisy(a):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    params = jax.tree.map(noisy, params)
    stats = jax.tree.map(noisy, stats)
    for leaf_path, leaf in jax.tree_util.tree_leaves_with_path(stats):
        if leaf_path[-1].key == "var":
            np.abs(leaf, out=leaf)
            leaf += 0.5
    return params, stats


def _images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _t(tree):
    return tree_from_jax(tree, device="cpu")


def _leaves_close(got, want, atol):
    want_leaves = jax.tree.leaves(_np(want))
    got_leaves = t_train.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=atol, rtol=0)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("depth,size", [(18, 32), (50, 32), (18, 35),
                                        (50, 38)])
def test_apply_logits_and_every_stat_match_jax(depth, size, train):
    jcfg, tcfg = _cfgs(depth)
    params, stats = _weights(depth)
    x = _images(8, size, seed=size)
    jl, jn = jr.apply(params, stats, jnp.asarray(x), jcfg, train=train)
    with torch.no_grad():
        tl, tn = tr.apply(_t(params), _t(stats), torch.from_numpy(x), tcfg,
                          train=train)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (8, 10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _leaves_close(tn, jn, 1e-4)
    if not train:       # eval returns the statistics it was given
        _leaves_close(tn, stats, 0)


@pytest.mark.parametrize("size", [32, 30, 33])
@pytest.mark.parametrize("s2d", [True, False])
def test_stem_matches_jax_with_and_without_s2d(s2d, size):
    jcfg, tcfg = _cfgs(50, stem_s2d=s2d)
    w = _weights(50)[0]["stem"]["conv"]
    x = _images(2, size, seed=3)
    want = jr._stem(jnp.asarray(x), jnp.asarray(w), jcfg, jnp.float32)
    got = tr._stem(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                   torch.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_s2d_stem_equals_the_plain_stem():
    _, tcfg = _cfgs(50)
    w = torch.from_numpy(_weights(50)[0]["stem"]["conv"])
    x = torch.from_numpy(_images(2, 32, seed=4))
    a = tr._stem(x, w, tcfg, torch.float32)
    b = tr._conv(x, w, 2, torch.float32)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,k,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 1, (0, 0)), (57, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (7, 3, 2, (1, 1))])
def test_same_padding_is_xlas(n, k, stride, want):
    assert tr._same_pad(n, k, stride) == want


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("size", [8, 7])
def test_stride2_blocks_match_jax(depth, stage, size):
    """The first block of stages 1-3 alone: stride 2 on an even and an
    odd plane (the asymmetric padding), with its projection."""
    jcfg, tcfg = _cfgs(depth)
    params, stats = _weights(depth)
    bp, bs = params["stages"][stage][0], stats["stages"][stage][0]
    c_in = bp["conv0"].shape[2]
    x = np.random.default_rng(stage).standard_normal(
        (4, size, size, c_in)).astype(np.float32)
    for train in (True, False):
        want, want_bs = jr._block(jnp.asarray(x), bp, bs, jcfg, stride=2,
                                  train=train)
        with torch.no_grad():
            got, got_bs = tr._block(torch.from_numpy(x), _t(bp), _t(bs),
                                    tcfg, 2, train)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
        _leaves_close(got_bs, want_bs, 1e-4)


def test_max_pool_pads_high_with_minus_infinity():
    """On an even plane the 3x3/2 pool's windows start at pixel 0 (XLA
    pads 0 low, 1 high), not at -1 as ``padding=1`` would."""
    _, tcfg = _cfgs(18)
    params, stats = (_t(t) for t in _weights(18))
    x = torch.from_numpy(_images(1, 16, seed=5))
    h, _ = tr._trunk_in(params, stats, x, tcfg, False)
    pre = torch.relu(tr._bn(tr._stem(x, params["stem"]["conv"], tcfg,
                                     torch.float32),
                            params["stem"]["bn"], stats["stem"]["bn"], tcfg,
                            False)[0])
    assert tuple(h.shape) == (1, 4, 4, 8)
    torch.testing.assert_close(h[0, 0, 0], pre[0, 0:3, 0:3].amax((0, 1)))
    torch.testing.assert_close(h[0, 3, 3], pre[0, 6:8, 6:8].amax((0, 1)))


# ------------------------------------------------------ loss and grads

def _batch(n=8, size=32, seed=1):
    b = next(t_data.synthetic_images(n, size, 10, seed=seed))
    return b


def _t_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("depth", [18, 50])
def test_loss_and_every_gradient_match_jax(depth):
    jcfg, tcfg = _cfgs(depth)
    params, stats = _weights(depth)
    batch = _batch()

    def jloss(p):
        loss, (metrics, new) = jr.loss_fn(
            p, stats, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        return loss, metrics

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tparams = _t(params)
    leaves = t_train.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tl, (tm, _) = tr.loss_fn(tparams, _t(stats), _t_batch(batch), tcfg)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]),
                               rtol=1e-6)
    for g, w in zip(grads, jax.tree.leaves(_np(jg))):
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (tuple(w.shape), err, scale)


# ------------------------------------------------------------ the step

def _run_jax(params, stats, jcfg, accum, steps, batch):
    mesh = j_mesh.make_mesh(devices=jax.devices()[:1])
    opt = j_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    p_axes, _ = jr.logical_axes(jcfg)
    state = j_train.init_state(
        lambda k: jax.tree.map(jnp.asarray, params), opt, mesh, p_axes,
        jax.random.PRNGKey(0), extra=jax.tree.map(jnp.asarray, stats))
    step = j_train.make_train_step(j_train.stateful_loss(jr.loss_fn, jcfg),
                                   opt, mesh, accum_steps=accum)
    history, first_extra = [], None
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        history.append({k: float(v) for k, v in m.items()})
        if first_extra is None:
            first_extra = _np(state.extra)
    return state, history, first_extra


def _port_state(params, stats, opt):
    return t_train.init_state(
        lambda g, device: tree_from_jax(params, device=device), opt,
        device="cpu", extra=_t(stats))


def _run_port(params, stats, tcfg, accum, steps, batch):
    opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state = _port_state(params, stats, opt)
    step = t_train.make_train_step(t_train.stateful_loss(tr.loss_fn, tcfg),
                                   opt, accum_steps=accum)
    history, first_extra = [], None
    for _ in range(steps):
        state, m = step(state, _t_batch(batch))
        history.append({k: float(v) for k, v in m.items()})
        if first_extra is None:
            first_extra = state.extra
    return state, history, first_extra


@pytest.mark.parametrize("depth,accum", [(18, 1), (50, 1), (18, 2)])
def test_train_steps_match_jax(depth, accum):
    jcfg, tcfg = _cfgs(depth)
    params, stats = _weights(depth)
    batch = _batch()
    if accum > 1:
        batch = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
    jstate, jhist, jfirst = _run_jax(params, stats, jcfg, accum, 3, batch)
    tstate, thist, tfirst = _run_port(params, stats, tcfg, accum, 3, batch)
    assert tstate.step == int(jstate.step) == 3
    for t, j in zip(thist, jhist):
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    flips_allowed = 2 * LR * 2      # two updates at a nonzero rate
    diffs = [np.abs(g.detach().numpy() - w).ravel()
             for g, w in zip(t_train.tree_leaves(tstate.params),
                             jax.tree.leaves(_np(jstate.params)))]
    assert max(d.max() for d in diffs) <= flips_allowed
    # the share is taken over the whole model: a 32-element BN bias whose
    # gradient is rounding noise (a shift that the next block's batch
    # norm removes) cannot meet 0.1 % on its own
    assert (np.concatenate(diffs) > 1e-6).mean() <= 1e-3
    # after the first step (rate 0: equal weights) the statistics agree
    # to rounding; after three, the few elements Adam moved the other
    # way have shifted the activations by up to their 2·lr
    _leaves_close(tfirst, jfirst, 1e-4)
    _leaves_close(tstate.extra, jstate.extra, flips_allowed)
    # the statistics left the graph and really moved
    for t, before in zip(t_train.tree_leaves(tstate.extra),
                         jax.tree.leaves(stats)):
        assert not t.requires_grad and t.grad_fn is None
        assert not np.allclose(t.numpy(), before)


def test_accumulation_carries_the_stats_between_microbatches():
    """Two microbatches move every running mean twice: the result
    differs from one step on either half alone."""
    _, tcfg = _cfgs(18)
    params, stats = _weights(18)
    batch = _batch()
    halves = {k: v.reshape((2, 4) + v.shape[1:]) for k, v in batch.items()}
    both = _run_port(params, stats, tcfg, 2, 1, halves)[0]
    first = _run_port(params, stats, tcfg, 1, 1,
                      {k: v[0] for k, v in halves.items()})[0]
    mom = tcfg.bn_momentum
    a = both.extra["stem"]["bn"]["mean"].numpy()
    b = first.extra["stem"]["bn"]["mean"].numpy()
    assert not np.allclose(a, b)
    # mean after two = mom * (mean after first) + (1 - mom) * batch-2 mean
    x = torch.from_numpy(halves["image"][1])
    with torch.no_grad():
        h = tr._stem(x, _t(params)["stem"]["conv"], tcfg, torch.float32)
    np.testing.assert_allclose(
        a, mom * b + (1 - mom) * h.mean((0, 1, 2)).numpy(), atol=1e-5)


def test_eval_step_leaves_the_stats_untouched():
    _, tcfg = _cfgs(18)
    params, stats = _weights(18)
    opt = t_train.make_optimizer(LR)
    state = _port_state(params, stats, opt)
    run = t_train.make_eval_step(t_train.stateful_loss(tr.loss_fn, tcfg,
                                                       train=False))
    metrics = run(state, _t_batch(_batch()))
    assert np.isfinite(float(metrics["loss"]))
    _leaves_close(state.extra, stats, 0)


# -------------------------------------------------- trees and the rest

def test_init_params_layout_matches_jax():
    for depth in (18, 50):
        jcfg, tcfg = _cfgs(depth)
        jp, js = jr.init_params(jcfg, jax.random.PRNGKey(0))
        tp, ts = tr.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
        for j, t in ((jp, tp), (js, ts)):
            assert jax.tree.structure(_np(j)) == jax.tree.structure(
                params_to_numpy(t))
            for a, b in zip(jax.tree.leaves(j), t_train.tree_leaves(t)):
                assert a.shape == tuple(b.shape)
                assert b.dtype == torch.float32
        for s, stage in enumerate(tp["stages"]):
            for b, bp in enumerate(stage):
                last = "bn2" if depth == 50 else "bn1"
                assert float(bp[last]["scale"].abs().max()) == 0.0
                assert ("proj" in bp) == ("proj" in jp["stages"][s][b])


def test_tree_helpers_walk_lists_in_jax_order():
    tree = {"b": [torch.tensor(1.), {"z": torch.tensor(2.),
                                     "a": torch.tensor(3.)}],
            "a": (torch.tensor(4.), torch.tensor(5.))}
    got = [float(t) for t in t_train.tree_leaves(tree)]
    want = [float(x) for x in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), tree))]
    assert got == want == [4.0, 5.0, 1.0, 3.0, 2.0]
    doubled = t_train.tree_map(lambda t: 2 * t, tree)
    assert isinstance(doubled["b"], list) and isinstance(doubled["a"], tuple)
    assert [float(t) for t in t_train.tree_leaves(doubled)] == [
        8.0, 10.0, 2.0, 6.0, 4.0]
    summed = t_train.tree_map(lambda a, b: a + b, tree, doubled)
    assert float(summed["b"][1]["z"]) == 6.0


def test_checkpoint_round_trip_of_a_resnet_state(tmp_path):
    """List-valued params and non-empty ``extra`` through save → restore,
    equal leaf for leaf (the generalised tree helpers)."""
    _, tcfg = _cfgs(18)
    params, stats = _weights(18)
    opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state = _port_state(params, stats, opt)
    step = t_train.make_train_step(t_train.stateful_loss(tr.loss_fn, tcfg),
                                   opt)
    for _ in range(2):
        state, _ = step(state, _t_batch(_batch()))
    ckpt = t_ckpt.Checkpointer(tmp_path, async_save=False)
    assert ckpt.save(state)
    fresh = _port_state(params, stats, opt)
    restored = ckpt.restore(fresh)
    assert restored.step == 2 and restored.opt_state["count"] == 2
    assert isinstance(restored.params["stages"], list)
    for name in ("params", "extra"):
        got = t_train.tree_leaves(getattr(restored, name))
        want = t_train.tree_leaves(getattr(state, name))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for key in ("mu", "nu"):
        for g, w in zip(t_train.tree_leaves(restored.opt_state[key]),
                        t_train.tree_leaves(state.opt_state[key])):
            assert torch.equal(g, w)
    assert all(t.requires_grad for t in
               t_train.tree_leaves(restored.params))
    assert not any(t.requires_grad for t in
                   t_train.tree_leaves(restored.extra))
    # and training goes on from it exactly as from the live state
    a, _ = step(restored, _t_batch(_batch()))
    b, _ = step(state, _t_batch(_batch()))
    for g, w in zip(t_train.tree_leaves(a.params),
                    t_train.tree_leaves(b.params)):
        assert torch.equal(g, w)


def test_synthetic_images_feed_loss_fn():
    """NHWC float32 images and integer labels, the same numbers as the
    JAX package's source for one seed; ``loss_fn`` takes them as they
    are."""
    from kubeflow_tpu.compute import data as j_data
    got = next(t_data.synthetic_images(4, 32, 10, seed=7))
    want = next(j_data.synthetic_images(4, 32, 10, seed=7))
    assert got["image"].shape == (4, 32, 32, 3)
    assert got["image"].dtype == np.float32
    assert got["label"].dtype.kind == "i"
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    _, tcfg = _cfgs(18)
    params, stats = (_t(t) for t in _weights(18))
    loss, (metrics, _) = tr.loss_fn(params, stats, _t_batch(got), tcfg)
    assert np.isfinite(float(loss))
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0


def test_flops_per_sample_is_the_analytic_figure():
    assert tr.flops_per_sample() == jr.flops_per_sample() \
        == 3 * 2 * 4.09e9
    assert tr.STAGE_BLOCKS == jr.STAGE_BLOCKS
    assert tr.BOTTLENECK == jr.BOTTLENECK
