"""The port's mixture-of-experts slice against the JAX package.

Inputs are numpy from a seed; weights come from JAX ``init_params`` and
cross through numpy (``params_from_jax``). Everything is fp32 on the CPU
at a tiny size: d_model 32, 2-5 experts, ``block_m`` 8, at most 2
layers. JAX's ``gmm`` runs its real Pallas kernels (K6 ``_gmm_kernel``,
K7 ``_tgmm_kernel``) in interpret mode, as ``tests/test_grouped_matmul.py``
runs them; the port's wrappers take their plain versions on CPU tensors
(the kernels themselves are held to those on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerances, with their reasons:

- the layout (``padded_group_layout``): exact — integer arithmetic;
- the router's expert ids: exact (random fp32 inputs have no ties);
  probabilities, gates and the aux loss rtol 1e-5 / atol 1e-7;
- ``gmm`` forward, dx and dw, the MoE layers' outputs: rtol 1e-4 /
  atol 1e-5 (fp32 sums in another order);
- loss, ``moe_aux`` and the train metrics: rtol 1e-5; every gradient
  leaf: max |Δ| ≤ 1e-5 × that leaf's max |g| (reduction order only);
- params after 3 train steps: as ``tests/test_torch_train.py`` — within
  1e-6, or within 2·lr per nonzero-rate update on at most 0.1 % of the
  elements (Adam turns a near-zero gradient's last-bit difference into
  a step of up to lr either way).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu.compute.ops import grouped_matmul as j_gm
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import grouped_matmul as t_gm
from kubeflow_tpu_torch.compute.params import params_from_jax

LR = 1e-3


def _jcfg(**kw):
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                max_seq=16, dtype="float32", attention="dense",
                remat=False, scan_layers=True, d_ff=48, moe_experts=4,
                moe_top_k=2, moe_dropless=True, moe_gmm=True,
                moe_gmm_block_m=8)
    base.update(kw)
    return jt.Config(**base)


def _tcfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tt.Config)}
    fields.update(kw)
    return tt.Config(**fields)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))   # a writable copy


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got,
        np.asarray(want), rtol=rtol, atol=atol)


def _layer0(jcfg, seed=0):
    """Layer 0's weights as (JAX dict of fp32 arrays, the port's)."""
    params = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    jlp = jax.tree.map(lambda a: a[0], params["layers"])
    return jlp, {k: _t(v) for k, v in _np(jlp).items()}


def _hidden(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- layout

LAYOUT_KEYS = {
    "random": (np.random.default_rng(0).integers(0, 5, 37), 5),
    "skewed": (np.zeros(29, np.int64), 4),          # all rows on one group
    "empty_groups": (np.array([1, 1, 3, 1, 3, 3, 1]), 4),   # 0 and 2 empty
}


@pytest.mark.parametrize("case", sorted(LAYOUT_KEYS))
@pytest.mark.parametrize("block_m", [4, 8])
def test_padded_group_layout_equals_jax(case, block_m):
    key, groups = LAYOUT_KEYS[case]
    want = j_gm.padded_group_layout(jnp.asarray(key, jnp.int32), groups,
                                    block_m)
    got = t_gm.padded_group_layout(torch.from_numpy(key).int(), groups,
                                   block_m)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_expert_tiles_from_markers():
    key, groups = LAYOUT_KEYS["empty_groups"]
    _, be, first, last, m_pad = t_gm.padded_group_layout(
        torch.from_numpy(key), groups, 8)
    tiles = t_gm.expert_tiles(be, first, last, groups)
    # one tile each, in order; the trailing padding tiles belong to none
    assert tiles.tolist() == [[0, 1], [1, 2], [2, 3], [3, 4]]
    assert m_pad // 8 == 5


# ---------------------------------------------------------------- gmm

GMM_CASES = {
    # (rows, experts, k, n, block_m, key draw)
    "random": (96, 5, 16, 24, 8, None),
    "empty_experts": (40, 4, 16, 24, 8, (1, 3)),
}


def _gmm_case(name):
    m, e, k, n, bm, only = GMM_CASES[name]
    rng = np.random.default_rng(3)
    key = (rng.choice(only, m) if only else rng.integers(0, e, m)).astype(
        np.int32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    return key, x, w, bm


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_forward_dx_dw_match_jax(case):
    key, x, w, bm = _gmm_case(case)
    e = w.shape[0]
    pos, be, fst, lst, m_pad = j_gm.padded_group_layout(jnp.asarray(key), e,
                                                        bm)

    def jloss(x, w):
        xp = jnp.zeros((m_pad, x.shape[1]), x.dtype).at[pos].set(x)
        out = j_gm.gmm(xp, w, be, fst, lst, bm)[pos]
        return jnp.sum(jnp.sin(out)), out

    (_, jout), (jdx, jdw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))

    tpos, tbe, tfst, tlst, tm = t_gm.padded_group_layout(_t(key), e, bm)
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    xp = torch.zeros((tm, x.shape[1])).index_put((tpos.long(),), tx)
    tout = t_gm.gmm(xp, tw, tbe, tfst, tlst, bm)[tpos.long()]
    torch.sin(tout).sum().backward()
    _close(tout, jout)
    _close(tx.grad, jdx)
    _close(tw.grad, jdw)
    if case == "empty_experts":
        assert float(tw.grad[[0, 2]].abs().max()) == 0.0


def test_gmm_dw_alone_matches_jax_tgmm():
    key, x, w, bm = _gmm_case("random")
    e = w.shape[0]
    rng = np.random.default_rng(4)
    pos, be, fst, lst, m_pad = j_gm.padded_group_layout(jnp.asarray(key), e,
                                                        bm)
    xp = np.zeros((m_pad, x.shape[1]), np.float32)
    xp[np.asarray(pos)] = x
    dy = rng.standard_normal((m_pad, w.shape[2])).astype(np.float32)
    want = j_gm._tgmm(jnp.asarray(xp), jnp.asarray(dy), be, fst, lst, e, bm)
    got = t_gm.grouped_matmul_dw(_t(xp), _t(dy), _t(be), _t(fst), _t(lst), e,
                                 bm)
    assert got.dtype == torch.float32 and got.shape == (e,) + xp.shape[1:] \
        + (dy.shape[1],)
    _close(got, want)


# ------------------------------------------------------- router, layers

@pytest.mark.parametrize("top_k", [1, 2])
def test_router_and_aux_match_jax(top_k):
    jcfg = _jcfg(moe_top_k=top_k)
    jlp, tlp = _layer0(jcfg)
    h = _hidden((2, 16, 32), 5)
    jp, jg, ji = jt._router(jnp.asarray(h), jlp, jcfg)
    tp, tg, ti = tt._router(_t(h), tlp, _tcfg(jcfg))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp, rtol=1e-5, atol=1e-7)
    _close(tg, jg, rtol=1e-5, atol=1e-7)
    _close(tt._moe_aux(tp, ti, 4), jt._moe_aux(jp, ji, 4), rtol=1e-5,
           atol=1e-7)


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (1, 0.5)])
def test_switch_moe_matches_jax(top_k, cf):
    jcfg = _jcfg(moe_top_k=top_k, moe_capacity_factor=cf,
                 moe_dropless=False)
    jlp, tlp = _layer0(jcfg)
    h = _hidden((2, 16, 32), 6)
    jout, jaux = jt._switch_moe(jnp.asarray(h), jlp, jcfg)
    tout, taux = tt._switch_moe(_t(h), tlp, _tcfg(jcfg))
    _close(tout, jout)
    _close(taux, jaux, rtol=1e-5, atol=1e-7)
    if cf < 1:   # the case drops tokens: some rows get no expert at all
        assert int((tout.abs().amax(-1) == 0).sum()) > 0


def _jax_dropless(h, jlp, jcfg):
    mesh = j_mesh.make_mesh(devices=jax.devices()[:1])
    with jax.set_mesh(mesh):
        return jax.jit(lambda h: jt._dropless_moe(h, jlp, jcfg))(h)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("engine", [True, False])
def test_dropless_moe_matches_jax(engine, top_k):
    jcfg = _jcfg(moe_top_k=top_k, moe_gmm=engine)
    jlp, tlp = _layer0(jcfg)
    h = _hidden((2, 16, 32), 7)
    jout, jaux = _jax_dropless(jnp.asarray(h), jlp, jcfg)
    tout, taux = tt._dropless_moe(_t(h), tlp, _tcfg(jcfg))
    _close(tout, jout)
    _close(taux, jaux, rtol=1e-5, atol=1e-7)


def test_both_dropless_engines_agree_and_auto_takes_the_grouped_matmul():
    jcfg = _jcfg()
    _, tlp = _layer0(jcfg)
    h = _t(_hidden((2, 16, 32), 8))
    outs = [tt._dropless_moe(h, tlp, _tcfg(jcfg, moe_gmm=g))[0]
            for g in (True, False, "auto")]
    _close(outs[0], outs[1].numpy())
    assert torch.equal(outs[0], outs[2])


# ------------------------------------------------------------- params

def test_init_params_moe_shapes_and_fan_in():
    jcfg = _jcfg(n_layers=2, moe_experts=4, d_ff=64)
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          jt.init_params(jcfg, jax.random.PRNGKey(0)))
    p = tt.init_params(_tcfg(jcfg), torch.Generator().manual_seed(1),
                       device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p,
                        is_leaf=torch.is_tensor) == shapes
    assert "w_gate" not in p["layers"]
    fan_in = {"router": 32, "we_gate": 32, "we_up": 32, "we_down": 64,
              "wq": 32, "wo": 4}
    for name, n in fan_in.items():
        std = float(p["layers"][name].std())
        np.testing.assert_allclose(std, n ** -0.5, rtol=0.1, err_msg=name)
    for name in ("attn_norm", "mlp_norm"):
        assert bool((p["layers"][name] == 1).all())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(moe_experts=2, moe_top_k=1, d_ff=0, n_layers=1),
    dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8,
         max_seq=1024, d_ff=0, moe_experts=8, moe_top_k=2)])
def test_param_count_and_flops_match_jax(kw):
    jcfg = _jcfg(**kw)
    assert tt.param_count(_tcfg(jcfg)) == jt.param_count(jcfg)
    assert tt.flops_per_token(_tcfg(jcfg)) == jt.flops_per_token(jcfg)
    if kw.get("vocab_size") == 32000:          # the MoE flagship
        assert tt.param_count(_tcfg(jcfg)) == 652_821_504


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_from_jax_on_the_moe_tree(scan_layers):
    jcfg = _jcfg(scan_layers=scan_layers)
    tree = _np(jt.init_params(jcfg, jax.random.PRNGKey(2)))
    p = params_from_jax(tree, device="cpu")
    layers = tree["layers"]
    if not scan_layers:
        assert isinstance(layers, list)
        layers = {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}
    assert set(p["layers"]) == set(layers)
    for k, v in layers.items():
        np.testing.assert_array_equal(p["layers"][k].numpy(), v)


# --------------------------------------------------------- loss, train

def _batch(seed=1, b=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 64, (b, 16)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _t_flat(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t.detach().numpy() for n, t in v.items()})
        else:
            out[k] = v.detach().numpy()
    return out


@pytest.mark.parametrize("kw", [dict(moe_top_k=2, moe_dropless=True),
                                dict(moe_top_k=1, moe_dropless=False)],
                         ids=["dropless_top2", "capacity_top1"])
def test_loss_moe_aux_and_grads_match_jax(kw):
    jcfg = _jcfg(**kw)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch()
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jcfg), has_aux=True)(jparams)
    params = params_from_jax(_np(jparams), device="cpu")
    for t in t_train.tree_leaves(params):
        t.requires_grad_(True)
    tl, tm = tt.loss_fn(params, {k: _t(v) for k, v in batch.items()},
                        _tcfg(jcfg))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    grads = _t_flat(t_train.tree_map(lambda t: t.grad, params))
    want = _flat(jg)
    assert grads.keys() == want.keys()
    for name in want:
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(grads[name] - want[name]).max())
        assert scale > 0 and err <= 1e-5 * scale, (name, err, scale)


def test_remat_gives_the_same_moe_gradients():
    jcfg = _jcfg()
    tree = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = {k: _t(v) for k, v in _batch().items()}
    grads = []
    for remat in (False, True):
        params = params_from_jax(tree, device="cpu")
        leaves = t_train.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tt.loss_fn(params, batch, _tcfg(jcfg, remat=remat))
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_train_steps_match_jax():
    jcfg = _jcfg()
    batch = _batch(seed=2)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    mesh = j_mesh.make_mesh(devices=jax.devices()[:1])
    jopt = j_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    jstate = j_train.init_state(lambda k: jparams, jopt, mesh,
                                jt.logical_axes(jcfg), jax.random.PRNGKey(0))
    jstep = j_train.make_train_step(j_train.plain_loss(jt.loss_fn, jcfg),
                                    jopt, mesh)
    topt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    tstate = t_train.init_state(
        lambda g, device: params_from_jax(_np(jparams), device=device),
        topt, device="cpu")
    tstep = t_train.make_train_step(t_train.plain_loss(tt.loss_fn,
                                                       _tcfg(jcfg)), topt)
    for _ in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        assert set(tm) == set(jm) and "moe_aux" in tm
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    got, want = _t_flat(tstate.params), _flat(jstate.params)
    for name in want:
        d = np.abs(got[name] - want[name])
        assert d.max() <= 2 * LR * 2, name
        assert (d > 1e-6).mean() <= 1e-3, name
