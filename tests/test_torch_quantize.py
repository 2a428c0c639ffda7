"""The port's int8 quantization against the JAX reference.

Same inputs (numpy, from a seed) through ``kubeflow_tpu.compute.quantize``
and ``kubeflow_tpu_torch.compute.quantize``:

- ``kv_quantize`` codes and scales bit-identical for fp32 and bf16
  inputs, on random pool-shaped draws, all-zero rows (scale 1) and rows
  holding exact .5 ties (round half to even);
- ``kv_dequantize`` bit-identical in fp32 and bf16 (each operand cast to
  the dtype first, the product in the dtype);
- ``quantize_array`` (per channel, another axis, a 1-D leaf),
  ``quantize_tree``, ``dequantize_tree`` and ``quantized_bytes`` on a
  small transformer's parameter tree, fp32 and bf16 leaves.

Every comparison is exact: both sides divide in IEEE fp32 and round once.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import quantize as jq
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import quantize as tq
from kubeflow_tpu_torch.compute.params import tree_from_jax


def _both(x, dtype):
    """One fp32 numpy array → (jax array, torch tensor) of ``dtype``;
    both round fp32 → bf16 to nearest even, so the inputs are equal."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(
                getattr(torch, dtype)))


def _np(t):
    """A tensor → numpy, bf16 as ml_dtypes' bfloat16 (bit for bit)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _equal(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _kv_draw(seed, shape=(6, 8, 2, 32)):
    """A pool-shaped draw with an all-zero row, rows of exact ties, a
    row whose amax sits far above the rest, and a row of tiny values."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(0.1, 8.0, size=shape[:-1]
                                              + (1,))).astype(np.float32)
    x[0, 0, 0] = 0.0
    # amax 127 → scale exactly 1: x / scale lands on .5 ties
    x[0, 1, 0] = 0.0
    x[0, 1, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    # amax 254 → scale 2: 5, 7, -9, 3 → 2.5, 3.5, -4.5, 1.5
    x[0, 1, 1] = 0.0
    x[0, 1, 1, :5] = [254.0, 5.0, 7.0, -9.0, 3.0]
    x[0, 2, 0] = 1e-3
    x[0, 2, 0, 0] = 1e4
    x[1, 0, 1] = rng.normal(size=shape[-1]) * 1e-30
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_quantize_bit_identical(dtype, seed):
    jx, tx = _both(_kv_draw(seed), dtype)
    jcodes, jscale = jq.kv_quantize(jx)
    codes, scale = tq.kv_quantize(tx)
    _equal(codes, jcodes)
    _equal(scale, jscale)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == tx.shape[:-1] + (1,)
    # the hand-built rows say what the rule is, not only that both agree
    assert float(scale[0, 0, 0, 0]) == 1.0 and not codes[0, 0, 0].any()
    if dtype == "float32":
        assert codes[0, 1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
        assert codes[0, 1, 1, :5].tolist() == [127, 2, 4, -4, 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_dequantize_bit_identical(dtype):
    jx, tx = _both(_kv_draw(3), "float32")
    jcodes, jscale = jq.kv_quantize(jx)
    codes, scale = tq.kv_quantize(tx)
    want = jq.kv_dequantize(jcodes, jscale, getattr(jnp, dtype))
    got = tq.kv_dequantize(codes, scale, getattr(torch, dtype))
    _equal(got, want)


def test_kv_round_trip_stays_within_half_a_step():
    x = torch.from_numpy(_kv_draw(4))
    codes, scale = tq.kv_quantize(x)
    back = tq.kv_dequantize(codes, scale, torch.float32)
    assert bool(((back - x).abs() <= scale / 2 * (1 + 1e-6)).all())


@pytest.mark.parametrize("shape,axis", [((64, 96), -1), ((64, 96), 0),
                                        ((4, 8, 16), -1), ((300,), -1)])
def test_quantize_array_bit_identical(shape, axis):
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    w.reshape(-1)[:3] = 0.0
    if len(shape) == 2:
        w[:, 0] = 0.0           # an all-zero channel: scale 1
    want = jq.quantize_array(w, axis=axis)
    got = tq.quantize_array(torch.from_numpy(w), axis=axis)
    assert got["_int8"] is True
    _equal(got["q"], want["q"])
    _equal(got["scale"], want["scale"])


def _jcfg():
    return jt.Config(vocab_size=64, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, max_seq=64, dtype="float32",
                     attention="dense", remat=False, scan_layers=True)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray,
                        jt.init_params(_jcfg(), jax.random.PRNGKey(5)))


def _walk(got, want):
    """Pairs of matching leaves of two trees (a quantized leaf is one)."""
    if isinstance(want, dict) and "_int8" in want:
        yield got, want
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            yield from _walk(got[k], want[k])
    else:
        yield got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("min_size", [tq.MIN_QUANT_SIZE, 1024])
def test_quantize_tree_and_bytes_match_jax(jparams, dtype, min_size):
    assert tq.MIN_QUANT_SIZE == jq.MIN_QUANT_SIZE
    jtree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                         jparams)
    ttree = tree_from_jax(jparams, dtype=getattr(torch, dtype),
                          device="cpu")
    jquant = jq.quantize_tree(jtree, min_size=min_size)
    tquant = tq.quantize_tree(ttree, min_size=min_size)
    n_quantized = 0
    for got, want in _walk(tquant, jquant):
        if isinstance(want, dict):
            n_quantized += 1
            _equal(got["q"], want["q"])
            _equal(got["scale"], want["scale"])
        else:
            assert isinstance(got, torch.Tensor)      # passed through
            _equal(got, want)
    assert n_quantized >= 3
    assert tq.quantized_bytes(tquant) == jq.quantized_bytes(jquant)
    # and back: dequantize_tree in bf16 and fp32, bit for bit
    for out in ("bfloat16", "float32"):
        jback = jq.dequantize_tree(jquant, getattr(jnp, out))
        tback = tq.dequantize_tree(tquant, getattr(torch, out))
        for got, want in _walk(tback, jax.tree.map(np.asarray, jback)):
            _equal(got, want)


def test_quantized_bytes_counts_int8_and_scales():
    tree = {"w": torch.zeros((64, 128)), "b": torch.zeros((128,)),
            "layers": [{"u": torch.ones((32, 256))}]}
    quant = tq.quantize_tree(tree)
    assert quant["b"] is tree["b"] and quant["layers"][0]["u"]["_int8"]
    qb, fb = tq.quantized_bytes(quant)
    assert fb == (64 * 128 + 128 + 32 * 256) * 4
    assert qb == 64 * 128 + 128 * 4 + 128 * 4 + 32 * 256 + 256 * 4
