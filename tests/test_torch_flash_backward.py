"""The port's flash attention forward + backward against the JAX
package's.

The port's ``flash_attention`` is a ``torch.autograd.Function`` (K3
forward, K4 + K5 backward on the card); on CPU tensors it runs the
plain versions ``flash_attention_reference`` and
``flash_attention_bwd_reference`` — the functions the kernels are held
to on the card. Here they go against ``jax.vjp`` of the JAX
``flash_attention`` with its Pallas kernels in interpret mode, as
``tests/test_compute_attention.py`` runs them, with ``block_q`` 16 and
``block_k`` 32 below S = 64 so several tiles and the causal skips run.
JAX repeats K/V before its kernels; for GQA its per-head dK/dV are
summed over each group here before the comparison.

Inputs come from numpy with a seed. Tolerances, relative to the
reference gradient's max |value|: fp32 5e-6 (reduction order: the
port sums a whole row at once, the JAX kernels tile by tile; 9e-7
seen); bf16 2e-2 (7.6e-3 seen; ``ds`` and ``p`` are rounded to bf16
once on both sides, but an fp32 sum that differs in its last bits can round to the neighbouring
bf16 value, and JAX sums the group's per-head dK/dV after rounding each
to bf16 where the port rounds the fp32 sum once).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu_torch.compute import attention as t_attn
from kubeflow_tpu_torch.compute.ops import flash_attention as t_flash

j_flash = importlib.import_module("kubeflow_tpu.compute.ops.flash_attention")

B, S, H = 2, 64, 4
TOL = {"float32": 5e-6, "bfloat16": 2e-2}


def _inputs(seed, kv, D, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, S, h, D)).astype(np.float32)
              for h in (H, kv, kv, H)]          # q, k, v, dO
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _jax_grads(jq, jk, jv, jdo, causal, n_rep):
    fn = functools.partial(j_flash.flash_attention, causal=causal,
                           block_q=16, block_k=32, interpret=True)

    def f(q, k, v):
        return fn(q, jnp.repeat(k, n_rep, axis=2), jnp.repeat(v, n_rep,
                                                               axis=2))

    out, vjp = jax.vjp(f, jq, jk, jv)
    return out, vjp(jdo)


def _assert_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max |Δ| {err} vs max |ref| {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa4:2"])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_forward_backward_matches_jax(dtype, causal, kv, D):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(D + kv, kv, D, dtype)
    n_rep = H // kv
    want_out, (jdq, jdk, jdv) = _jax_grads(jq, jk, jv, jdo, causal, n_rep)
    # JAX's dK/dV are per kv head already: jnp.repeat's VJP summed the
    # group's per-head values
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out, lse = t_flash.flash_attention(q, k, v, causal=causal)
    assert not lse.requires_grad
    out.backward(tdo)
    tol = TOL[dtype]
    _assert_close(out, want_out, tol, "out")
    for name, got, want in (("dq", q.grad, jdq), ("dk", k.grad, jdk),
                            ("dv", v.grad, jdv)):
        assert got.dtype == getattr(torch, dtype)
        _assert_close(got, want, tol, name)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_group_sum_against_per_head_jax(causal):
    """fp32, 4 query heads over 1 kv head: the port's native group sum
    equals JAX's per-head dK/dV of the repeated K/V summed over heads."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(7, 1, 32, "float32")
    fn = functools.partial(j_flash.flash_attention, causal=causal,
                           block_q=16, block_k=32, interpret=True)
    kr, vr = (jnp.repeat(x, H, axis=2) for x in (jk, jv))
    _, vjp = jax.vjp(fn, jq, kr, vr)
    _, jdk, jdv = vjp(jdo)
    assert jdk.shape == (B, S, H, 32)           # per query head
    dq, dk, dv = t_flash.flash_attention_bwd(
        tq, tk, tv, *t_flash.flash_attention(tq, tk, tv, causal=causal),
        tdo, causal=causal)
    _assert_close(dk, jnp.sum(jdk, axis=2, keepdims=True), 5e-6, "dk")
    _assert_close(dv, jnp.sum(jdv, axis=2, keepdims=True), 5e-6, "dv")


@pytest.mark.parametrize("n_rep", [1, 2])
def test_backward_matches_plain_autograd(n_rep):
    """fp32: the backward equals autograd through the port's plain
    dense attention (an independent derivation of the same gradient)."""
    rng = np.random.default_rng(n_rep)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 24, h, 32)).astype(
        np.float32)) for h in (4, 4 // n_rep, 4 // n_rep))
    do = torch.from_numpy(rng.normal(size=(2, 24, 4, 32)).astype(
        np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    t_flash.flash_attention(*a, causal=True)[0].backward(do)
    t_attn.dense_attention(b[0], t_attn.repeat_kv(b[1], n_rep),
                           t_attn.repeat_kv(b[2], n_rep)).backward(do)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=2e-5, rtol=1e-5)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.normal(size=(1, 40, 4, 32)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, 40, 2, 32)).astype(
        np.float32)) for _ in range(2))
    counts = (t_flash.flash_attention.launches,
              t_flash.flash_attention_bwd_dq.launches,
              t_flash.flash_attention_bwd_dkv.launches)
    out, lse = t_flash.flash_attention(q, k, v)
    delta = t_flash.attention_delta(out, do)
    assert delta.shape == (1, 4, 40)
    want = t_flash.flash_attention_bwd_reference(q, k, v, out, lse, do)
    dq = t_flash.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = t_flash.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    for got, ref in zip((dq, dk, dv), want):
        assert torch.equal(got, ref)
    assert counts == (t_flash.flash_attention.launches,
                      t_flash.flash_attention_bwd_dq.launches,
                      t_flash.flash_attention_bwd_dkv.launches)
