"""The port's BERT against the JAX package's, on the CPU in fp32.

Weights come from JAX ``init_params`` and cross through
``tree_from_jax`` (which keeps the stacked or the per-layer layout of
``layers`` as it is); batches are ``mlm_batch`` numpy from a seed. The
tiny shape: vocab 128, d_model 64, 2 layers, 4 heads (head_dim 16), d_ff
128, S 32. ``attention="flash"`` runs JAX's Pallas kernels in interpret
mode and the port's plain versions of K3/K4/K5 (non-causal).

Tolerances: logits 1e-4 absolute (fp32 reduction order), loss and
``mlm_accuracy`` rtol 1e-5, every gradient leaf max |Δ| ≤ 1e-4 × that
leaf's max |g| (or 1e-7 absolute where the gradient is zero
analytically and both sides hold rounding noise: the key bias).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import bert as jb
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import bert as tb
from kubeflow_tpu_torch.compute.ops import flash_attention as t_flash
from kubeflow_tpu_torch.compute.params import tree_from_jax

LAYOUTS = [("dense", True), ("dense", False), ("flash", True),
           ("flash", False)]


def _cfgs(attention="flash", scan_layers=True, **kw):
    fields = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  d_ff=128, max_seq=32, dtype="float32", remat=False,
                  attention=attention, scan_layers=scan_layers,
                  max_predictions=8)
    fields.update(kw)
    return jb.Config(**fields), tb.Config(**fields)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(jcfg, seed=1):
    """JAX's init with every bias and norm leaf perturbed (zeros and
    ones would hide a misplaced bias)."""
    params = _np(jb.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)


def _batch(jcfg, n=3, seed=2):
    return jb.mlm_batch(np.random.default_rng(seed), n, jcfg)


def _t_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("attention,scan", LAYOUTS)
def test_apply_logits_match_jax(attention, scan):
    jcfg, tcfg = _cfgs(attention, scan)
    params = _weights(jcfg)
    b = _batch(jcfg)
    types = (np.arange(32)[None, :] >= 16).astype(np.int32).repeat(3, 0)
    for tt in (None, types):
        want = jb.apply(params, jnp.asarray(b["tokens"]), jcfg,
                        None if tt is None else jnp.asarray(tt))
        with torch.no_grad():
            got = tb.apply(tree_from_jax(params, device="cpu"),
                           torch.from_numpy(b["tokens"]), tcfg,
                           None if tt is None else torch.from_numpy(tt))
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (3, 32, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("attention,scan", LAYOUTS)
def test_loss_accuracy_and_every_gradient_match_jax(attention, scan):
    jcfg, tcfg = _cfgs(attention, scan)
    params = _weights(jcfg)
    b = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jb.loss_fn(p, _j_batch(b), jcfg), has_aux=True)(params)
    tparams = tree_from_jax(params, device="cpu")
    leaves = t_train.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = tb.loss_fn(tparams, _t_batch(b), tcfg)
    grads = t_train._grads(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["mlm_accuracy"]),
                               float(jm["mlm_accuracy"]), rtol=1e-5,
                               atol=1e-7)
    want = jax.tree.leaves(_np(jg))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        # bk's gradient is zero analytically (a softmax ignores a shift
        # of all its scores): both frameworks leave ~1e-8 of rounding
        assert err <= max(1e-4 * scale, 1e-7), (w.shape, err, scale)


def test_fewer_masked_positions_than_max_predictions():
    """Rows with 0, 1 and 3 masked positions against max_predictions 8:
    the stable sort pads with the same weight-0 positions as JAX, and
    the loss counts only the masked ones."""
    jcfg, tcfg = _cfgs("dense")
    params = _weights(jcfg)
    b = _batch(jcfg)
    b["mask"][:] = 0
    b["mask"][1, 5] = 1
    b["mask"][2, [3, 17, 30]] = 1
    jl, jm = jb.loss_fn(params, _j_batch(b), jcfg)
    with torch.no_grad():
        tl, tm = tb.loss_fn(tree_from_jax(params, device="cpu"),
                            _t_batch(b), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["mlm_accuracy"]),
                               float(jm["mlm_accuracy"]), atol=1e-7)
    # no masked position at all: the loss is 0, not NaN
    b["mask"][:] = 0
    with torch.no_grad():
        tl, _ = tb.loss_fn(tree_from_jax(params, device="cpu"),
                           _t_batch(b), tcfg)
    assert float(tl) == 0.0 == float(jb.loss_fn(params, _j_batch(b),
                                                jcfg)[0])


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(tb._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(tb._gelu(torch.from_numpy(x)).numpy() - exact).max() > 1e-4


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = jb._ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bias), 1e-12)
    got = tb._ln(torch.from_numpy(x), torch.from_numpy(s),
                 torch.from_numpy(bias), 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_remat_gives_the_same_gradients_and_reruns_the_forward():
    jcfg, _ = _cfgs("flash", False)
    params = _weights(jcfg)
    b = _t_batch(_batch(jcfg))
    grads = []
    for remat in (False, True):
        tcfg = dataclasses.replace(_cfgs("flash", False)[1], remat=remat)
        tparams = tree_from_jax(params, device="cpu")
        leaves = t_train.tree_leaves(tparams)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tb.loss_fn(tparams, b, tcfg)
        grads.append(t_train._grads(loss, leaves))
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, atol=1e-7, rtol=1e-6)


def test_ring_attention_waits_for_the_mesh():
    """On one device BERT's ring is the ring of one position: its
    logits equal dense attention's within fp32 rounding (1e-4, as the
    logits above) and its loss within rtol 1e-5."""
    jcfg, _ = _cfgs("dense")
    params = tree_from_jax(_weights(jcfg), device="cpu")
    b = _t_batch(_batch(jcfg))
    ring, dense = _cfgs("ring")[1], _cfgs("dense")[1]
    torch.testing.assert_close(tb.apply(params, b["tokens"], ring),
                               tb.apply(params, b["tokens"], dense),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(tb.loss_fn(params, b, ring)[0],
                               tb.loss_fn(params, b, dense)[0],
                               atol=0, rtol=1e-5)


@pytest.mark.parametrize("scan", [True, False])
def test_init_params_layout_and_counts_match_jax(scan):
    jcfg, tcfg = _cfgs("flash", scan)
    jp = jb.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tb.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert isinstance(tp["layers"], dict if scan else list)
    want = jax.tree.leaves(jp)
    got = t_train.tree_leaves(tp)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert tb.param_count(tcfg) == jb.param_count(jcfg) \
        == sum(t.numel() for t in got)
    assert tb.flops_per_token(tcfg) == jb.flops_per_token(jcfg)
    base_j, base_t = jb.Config(), tb.Config()
    assert tb.param_count(base_t) == jb.param_count(base_j)
    assert tb.flops_per_token(base_t) == jb.flops_per_token(base_j)
    assert dataclasses.asdict(base_t) == dataclasses.asdict(base_j)
    # ones for the norm scales, zeros for every bias, as in JAX
    lp = tp["layers"] if scan else tp["layers"][0]
    assert float(lp["ln1_scale"].min()) == 1.0
    assert float(lp["bq"].abs().max()) == 0.0


def test_mlm_batch_is_the_jax_packages():
    jcfg, tcfg = _cfgs()
    want = jb.mlm_batch(np.random.default_rng(5), 4, jcfg)
    got = tb.mlm_batch(np.random.default_rng(5), 4, tcfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_train_steps_match_jax():
    """Three steps of the JAX train step (optax) against the port's on
    the per-layer layout: the list-valued params through AdamW."""
    jcfg, tcfg = _cfgs("flash", False)
    params = _weights(jcfg)
    b = _batch(jcfg, n=4)
    lr = 1e-3
    mesh = j_mesh.make_mesh(devices=jax.devices()[:1])
    jopt = j_train.make_optimizer(lr, warmup_steps=1, total_steps=10)
    jstate = j_train.init_state(
        lambda k: jax.tree.map(jnp.asarray, params), jopt, mesh,
        jb.logical_axes(jcfg), jax.random.PRNGKey(0))
    jstep = j_train.make_train_step(j_train.plain_loss(jb.loss_fn, jcfg),
                                    jopt, mesh)
    topt = t_train.make_optimizer(lr, warmup_steps=1, total_steps=10)
    tstate = t_train.init_state(
        lambda g, device: tree_from_jax(params, device=device), topt,
        device="cpu")
    tstep = t_train.make_train_step(t_train.plain_loss(tb.loss_fn, tcfg),
                                    topt)
    for _ in range(3):
        jstate, jm = jstep(jstate, _j_batch(b))
        tstate, tm = tstep(tstate, _t_batch(b))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    names = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_leaves_with_path(_np(jstate.params))]
    diffs = {n: np.abs(g.detach().numpy() - w).ravel()
             for n, g, w in zip(names, t_train.tree_leaves(tstate.params),
                                jax.tree.leaves(_np(jstate.params)))}
    # Adam turns a gradient of any size into a step of about lr: where
    # two frameworks' gradients differ in sign the element moves 2·lr
    # apart per update. That is allowed for 0.1 % of the elements; the
    # key bias, whose gradient is nothing but rounding noise, is held to
    # the size of the steps only
    assert max(d.max() for d in diffs.values()) <= 2 * lr * 2
    rest = np.concatenate([d for n, d in diffs.items() if "bk" not in n])
    assert (rest > 1e-6).mean() <= 1e-3
    # on CPU tensors the wrappers ran their plain versions: no launch
    assert t_flash.flash_attention.launches == 0
