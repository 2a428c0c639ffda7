"""The port's fused bottleneck block (K8 wrapper, plain version on the
CPU) against the JAX package's.

The same numpy inputs, made from a seed, go through JAX's
``fused_bottleneck_eval`` (its Pallas kernel in interpret mode, the
default off the TPU), JAX's ``resnet._block(train=False)`` and the
port's ``fused_bottleneck_eval`` / ``resnet._block``. BN scale, bias,
mean and variance are randomised: at init the last BN scale is 0, the
third product folds to nothing and a check would see only ``relu(x)``.

Tolerances: fp32 rtol/atol 1e-4 (reduction order only; the JAX test's
own); bf16 2e-2 of the reference's max |value| (outputs may round one
bf16 unit apart where the fp32 sums differ in their last bits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute.models import resnet as j_resnet
from kubeflow_tpu.compute.ops import fused_block as j_fused
from kubeflow_tpu_torch.compute.models import resnet as t_resnet
from kubeflow_tpu_torch.compute.ops import fused_block as t_fused
from kubeflow_tpu_torch.compute.params import tree_from_jax


def make_block(c, m, seed=0):
    """An identity bottleneck's ``(params, stats)`` as numpy trees in the
    JAX layout, He-normal convs, every BN quantity randomised."""
    rng = np.random.default_rng(seed)
    bp, bs = {}, {}
    for i, shape in enumerate(((1, 1, c, m), (3, 3, m, m), (1, 1, m, c))):
        fan_in = shape[0] * shape[1] * shape[2]
        bp[f"conv{i}"] = (rng.standard_normal(shape)
                          * (2 / fan_in) ** 0.5).astype(np.float32)
        ch = shape[-1]
        bp[f"bn{i}"] = {
            "scale": (1 + 0.1 * rng.standard_normal(ch)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(ch)).astype(np.float32)}
        bs[f"bn{i}"] = {
            "mean": (0.1 * rng.standard_normal(ch)).astype(np.float32),
            "var": (0.5 + np.abs(rng.standard_normal(ch))).astype(
                np.float32)}
    return bp, bs


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_from_jax(tree, device="cpu")


def test_fold_bn_matches_jax_and_the_unfolded_conv():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((1, 1, 8, 16)).astype(np.float32)
    bn_p = {"scale": np.linspace(0.5, 2.0, 16, dtype=np.float32),
            "bias": np.linspace(-1.0, 1.0, 16, dtype=np.float32)}
    bn_s = {"mean": np.linspace(-0.5, 0.5, 16, dtype=np.float32),
            "var": np.linspace(0.5, 1.5, 16, dtype=np.float32)}
    jw, jb = j_fused.fold_bn(jnp.asarray(w), _j(bn_p), _j(bn_s), eps=1e-5)
    tw, tb = t_fused.fold_bn(torch.from_numpy(w), _t(bn_p), _t(bn_s),
                             eps=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)
    x = torch.from_numpy(rng.standard_normal((2, 4, 4, 8)).astype(
        np.float32))
    raw = t_resnet._conv(x, torch.from_numpy(w), 1, torch.float32)
    s = _t(bn_p)["scale"] * torch.rsqrt(_t(bn_s)["var"] + 1e-5)
    want = raw * s + (_t(bn_p)["bias"] - _t(bn_s)["mean"] * s)
    got = t_resnet._conv(x, tw, 1, torch.float32) + tb
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,c,m", [((2, 8, 8), 256, 64),
                                       ((3, 7, 7), 64, 16),
                                       ((1, 5, 9), 32, 8)])
def test_fused_block_matches_jax_kernel_and_block_fp32(shape, c, m):
    bp, bs = make_block(c, m, seed=c)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    jcfg = j_resnet.Config(depth=50, dtype="float32")
    j_kernel = j_fused.fused_bottleneck_eval(jnp.asarray(x), _j(bp), _j(bs),
                                             eps=jcfg.bn_eps)
    j_block, _ = j_resnet._block(jnp.asarray(x), _j(bp), _j(bs), jcfg,
                                 stride=1, train=False)
    got = t_fused.fused_bottleneck_eval(torch.from_numpy(x), _t(bp), _t(bs),
                                        eps=jcfg.bn_eps)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_kernel),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_block),
                               rtol=1e-4, atol=1e-4)
    # and the port's own unfused block
    tcfg = t_resnet.Config(depth=50, dtype="float32")
    t_block, _ = t_resnet._block(torch.from_numpy(x), _t(bp), _t(bs), tcfg,
                                 stride=1, train=False)
    np.testing.assert_allclose(got.numpy(), t_block.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_fused_block_bf16_matches_jax_kernel():
    bp, bs = make_block(128, 32, seed=5)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 7, 128)).astype(np.float32)
    want = np.asarray(j_fused.fused_bottleneck_eval(
        jnp.asarray(x, jnp.bfloat16), _j(bp), _j(bs)).astype(jnp.float32))
    got = t_fused.fused_bottleneck_eval(
        torch.from_numpy(x).to(torch.bfloat16), _t(bp), _t(bs))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_zero_input_passes_bias_chain_and_relu():
    bp, bs = make_block(64, 16, seed=7)
    x = np.zeros((1, 6, 6, 64), np.float32)
    want = np.asarray(j_fused.fused_bottleneck_eval(jnp.asarray(x), _j(bp),
                                                    _j(bs)))
    got = t_fused.fused_bottleneck_eval(torch.from_numpy(x), _t(bp), _t(bs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the zero padding is of c1, not of x: border pixels differ from
    # interior ones even for a constant input
    assert not np.allclose(got.numpy()[0, 0, 0], got.numpy()[0, 3, 3])


def test_reference_equals_wrapper_on_cpu_and_counts_no_launch():
    bp, bs = make_block(64, 16, seed=8)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, 5, 64)).astype(np.float32))
    before = t_fused.fused_bottleneck_eval.launches
    got = t_fused.fused_bottleneck_eval(x, _t(bp), _t(bs))
    want = t_fused.fused_bottleneck_reference(x, _t(bp), _t(bs))
    assert torch.equal(got, want)
    assert t_fused.fused_bottleneck_eval.launches == before


def test_folded_operands_round_after_folding():
    """BN is folded in fp32 and THEN the weights are cast: the bf16
    operands are the rounding of the fp32 folded ones, biases fp32."""
    bp, bs = _t(make_block(64, 16, seed=9)[0]), _t(make_block(64, 16,
                                                              seed=9)[1])
    ops32 = t_fused.folded_operands(bp, bs, torch.float32)
    ops16 = t_fused.folded_operands(bp, bs, torch.bfloat16)
    assert [tuple(t.shape) for t in ops32] == [
        (64, 16), (16,), (9, 16, 16), (16,), (16, 64), (64,)]
    for a, b in zip(ops32[0::2], ops16[0::2]):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
    for a, b in zip(ops32[1::2], ops16[1::2]):
        assert b.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("case", ["proj", "stride", "width", "basic",
                                  "channels", "rank"])
def test_refusals_are_named(case):
    bp, bs = (_t(t) for t in make_block(64, 16, seed=10))
    x = torch.zeros((1, 4, 4, 64))
    kw = {}
    if case == "proj":
        bp["proj"] = torch.zeros((1, 1, 64, 64))
        match = "projection"
    elif case == "stride":
        kw["stride"] = 2
        match = "stride"
    elif case == "width":
        bp["conv2"] = torch.zeros((1, 1, 16, 128))
        bp["bn2"] = {k: torch.zeros(128) for k in ("scale", "bias")}
        bs["bn2"] = {k: torch.ones(128) for k in ("mean", "var")}
        match = "residual"
    elif case == "basic":
        del bp["conv2"]
        match = "bottleneck"
    elif case == "channels":
        x = torch.zeros((1, 4, 4, 32))
        match = "channels"
    else:
        x = torch.zeros((4, 4, 64))
        match = "NHWC"
    with pytest.raises(ValueError, match=match):
        t_fused.fused_bottleneck_eval(x, bp, bs, **kw)
