"""The port's TransformerLM against the JAX reference.

Weights come from JAX ``init_params`` and cross through numpy
(``params_from_jax``), tokens from numpy; fp32 comparisons hold 1e-4 /
1e-3 (reduction order), the bf16 port against the fp32 JAX oracle the
cross-precision envelope of ``tests/test_compute_generate.py`` (0.2 /
0.1 — bf16 rounds at other places in the two frameworks).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax


def _jcfg(**kw):
    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=32, dtype="float32",
                attention="dense", remat=False, scan_layers=True)
    base.update(kw)
    return jt.Config(**base)


def _tcfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tt.Config)}
    fields.update(kw)
    return tt.Config(**fields)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 128, (2, 16)).astype(
        np.int32)


def test_params_from_jax_scan_layout(jparams):
    tree = _np_tree(jparams)
    p = params_from_jax(tree, device="cpu")
    assert set(p) == set(tree)
    for k, v in tree["layers"].items():
        assert p["layers"][k].shape == v.shape
        np.testing.assert_array_equal(p["layers"][k].numpy(), v)
    np.testing.assert_array_equal(p["embed"].numpy(), tree["embed"])


def test_params_from_jax_list_layout_stacks_layers():
    cfg = _jcfg(scan_layers=False)
    tree = _np_tree(jt.init_params(cfg, jax.random.PRNGKey(1)))
    assert isinstance(tree["layers"], list)
    p = params_from_jax(tree, dtype=torch.bfloat16, device="cpu")
    for k in tree["layers"][0]:
        want = np.stack([lp[k] for lp in tree["layers"]])
        assert p["layers"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p["layers"][k].float().numpy(),
            np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32))


def test_params_from_jax_needs_a_device_without_cuda(jparams):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(_np_tree(jparams))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 0.02)])
def test_rope_matches_jax(dtype, tol):
    cfg = _jcfg()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.asarray([0, 1, 2, 3, 7, 100, 511, 1000, 31], np.int32)
    jc, js = jt.rope_tables(cfg, jnp.asarray(pos))
    tc, ts = tt.rope_tables(_tcfg(cfg), torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = jt.apply_rope(jnp.asarray(x, getattr(jnp, dtype)), jc, js)
    got = tt.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        tc, ts)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 0.02)])
def test_rmsnorm_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    want = jt._rmsnorm(jnp.asarray(x, getattr(jnp, dtype)),
                       jnp.asarray(s, getattr(jnp, dtype)))
    tdt = getattr(torch, dtype)
    got = tt._rmsnorm(torch.from_numpy(x).to(tdt),
                      torch.from_numpy(s).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_apply_fp32_matches_jax(jparams, tokens, attention):
    jcfg = _jcfg(attention=attention)
    want = jt.apply(jparams, jnp.asarray(tokens), jcfg)
    p = params_from_jax(_np_tree(jparams), device="cpu")
    got = tt.apply(p, torch.from_numpy(tokens), _tcfg(jcfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_apply_bf16_within_envelope_of_fp32_jax(jparams, tokens,
                                                attention):
    want = jt.apply(jparams, jnp.asarray(tokens), _jcfg())
    p = params_from_jax(_np_tree(jparams), device="cpu")
    got = tt.apply(p, torch.from_numpy(tokens),
                   _tcfg(_jcfg(), dtype="bfloat16", attention=attention))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.2,
                               rtol=0.1)


def test_init_params_layout_and_seed():
    cfg = _tcfg(_jcfg())
    a = tt.init_params(cfg, torch.Generator().manual_seed(5),
                       device="cpu")
    b = tt.init_params(cfg, torch.Generator().manual_seed(5),
                       device="cpu")
    shapes = jax.tree.map(lambda x: x.shape,
                          jt.init_params(_jcfg(), jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda x: tuple(x.shape), a,
                        is_leaf=torch.is_tensor) == shapes
    for k in ("embed", "head"):
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32


@pytest.mark.parametrize("kw,match", [
    (dict(pipeline_stages=2, n_layers=3), "not divisible"),
    (dict(pipeline_stages=2, scan_layers=False), "scan_layers")])
def test_config_refuses_unported_features(kw, match):
    """JAX's two pipeline refusals (``transformer.py:90-98``), with its
    messages: stages that do not divide the layers, and stages without
    the stacked layout."""
    with pytest.raises(ValueError, match=match) as want:
        jt.Config(**kw)
    with pytest.raises(ValueError, match=match) as got:
        tt.Config(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("role", ["target", "draft"])
def test_engine_refuses_moe_configs(role):
    """The engine refuses an MoE target whose dispatch has a capacity
    (dropped tokens are another model) and an MoE draft, as JAX's does
    (``generate.py:653-656``, ``:705-708``); a dropless MoE target is
    served (``tests/test_torch_afmoe.py``)."""
    from kubeflow_tpu_torch.compute.generate import GenerationEngine
    dense = _tcfg(_jcfg())
    moe = _tcfg(_jcfg(), moe_experts=4, moe_top_k=2,
                moe_dropless=role == "draft")
    params = tt.init_params(dense, torch.Generator().manual_seed(0),
                            device="cpu")
    if role == "target":
        kw = dict(config=moe)
    else:
        kw = dict(config=dense, draft_params=params, draft_config=moe,
                  spec_k=2)
    with pytest.raises(ValueError, match="MoE"):
        GenerationEngine(params, device="cpu", **kw)
