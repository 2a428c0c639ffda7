"""The port's plain attention reads against the JAX reference.

Same inputs (numpy, from a seed) through both frameworks:

- ``dense_attention``, ``decode_attention`` and the block-streamed
  ``paged_decode_attention`` of ``kubeflow_tpu_torch.compute.attention``
  against ``kubeflow_tpu.compute.attention``;
- the K1 plain version (``ops.paged_attention``, what the wrapper runs
  on a CPU tensor) against the JAX Pallas decode kernel, interpreted on
  the CPU as the JAX package's own tests run it;
- the K3 plain version's ``out`` and ``lse`` against the JAX flash
  forward — the Pallas ``_fwd`` where the sequence tiles, ``_flash_fwd``
  (XLA dense fallback) where it does not;
- the chunk-after-prefix reads — ``chunk_attention``, the streamed
  ``paged_chunk_attention`` and the K2 plain version with its CPU
  wrapper — against their JAX twins and the Pallas chunk kernel
  (interpreted), at an empty, a mid-block, a block-aligned and a
  per-slot ``[B]`` prefix.

Tolerances: fp32 1e-5 (reduction order only); bf16 0.02, the paged-read
tolerance of ``tests/test_paged_attention.py`` (bf16 rounds at other
places in the two frameworks).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import attention as j_attn
from kubeflow_tpu_torch.compute import attention as t_attn
from kubeflow_tpu_torch.compute.ops import flash_attention as t_flash
from kubeflow_tpu_torch.compute.ops import paged_attention as t_paged

j_paged = importlib.import_module("kubeflow_tpu.compute.ops.paged_attention")
j_flash = importlib.import_module("kubeflow_tpu.compute.ops.flash_attention")

DTYPES = [("float32", 1e-5), ("bfloat16", 0.02)]
N_REP = [1, 2, 4]
H = 4          # query heads; kv heads = H // n_rep
D = 16
BS = 8         # block size
BPS = 4        # blocks per slot
# inactive slot, one position, exact block multiple, the full table
LENGTHS = [0, 1, 2 * BS, BPS * BS]


def _both(x, dtype):
    """One numpy array → (jax array, torch tensor) of ``dtype``; both
    round fp32 → bf16 to nearest even, so the inputs are identical."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(
                getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        atol=tol, rtol=tol)


def _qkv(rng, S, kv, dtype, B=2):
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, kv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, kv, D)).astype(np.float32)
    return [_both(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", N_REP)
def test_dense_attention_matches_jax(dtype, tol, n_rep):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 12, H // n_rep, dtype)
    want = j_attn.dense_attention(jq, j_attn.repeat_kv(jk, n_rep),
                                  j_attn.repeat_kv(jv, n_rep))
    got = t_attn.dense_attention(tq, t_attn.repeat_kv(tk, n_rep),
                                 t_attn.repeat_kv(tv, n_rep))
    _close(got, want, tol)


def _pool(dtype, n_rep, seed=0):
    """A random pool with tables and per-slot lengths, in both
    frameworks, plus the gathered logical-order context."""
    rng = np.random.default_rng(seed)
    S, kv, N = len(LENGTHS), H // n_rep, 12
    kc = rng.normal(size=(N, BS, kv, D)).astype(np.float32)
    vc = rng.normal(size=(N, BS, kv, D)).astype(np.float32)
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    tables = rng.integers(0, N, size=(S, BPS)).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    j, t = zip(*(_both(x, dtype) for x in (q, kc, vc)))
    j_tabs = (jnp.asarray(tables), jnp.asarray(lengths))
    t_tabs = (torch.from_numpy(tables), torch.from_numpy(lengths))
    return j, t, j_tabs, t_tabs


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", N_REP)
def test_decode_attention_matches_jax(dtype, tol, n_rep):
    (jq, jkc, jvc), (tq, tkc, tvc), (jt, jl), (tt, tl) = _pool(dtype,
                                                               n_rep)
    S, T = jt.shape[0], BPS * BS
    want = j_attn.decode_attention(
        jq, j_attn.repeat_kv(jkc[jt].reshape(S, T, -1, D), n_rep),
        j_attn.repeat_kv(jvc[jt].reshape(S, T, -1, D), n_rep), jl)
    got = t_attn.decode_attention(
        tq, t_attn.repeat_kv(tkc[tt.long()].reshape(S, T, -1, D), n_rep),
        t_attn.repeat_kv(tvc[tt.long()].reshape(S, T, -1, D), n_rep), tl)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", N_REP)
def test_paged_stream_matches_jax(dtype, tol, n_rep):
    (jq, jkc, jvc), (tq, tkc, tvc), (jt, jl), (tt, tl) = _pool(dtype,
                                                               n_rep)
    want = j_attn.paged_decode_attention(jq, (jkc, jvc), jt, jl,
                                         block_size=BS, n_rep=n_rep)
    got = t_attn.paged_decode_attention(tq, (tkc, tvc), tt, tl,
                                        block_size=BS, n_rep=n_rep)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", N_REP)
def test_k1_plain_matches_jax_kernel(dtype, tol, n_rep):
    """The K1 wrapper on CPU tensors (its plain version) against the
    Pallas decode kernel in interpret mode; lengths 0 stay finite."""
    (jq, jkc, jvc), (tq, tkc, tvc), (jt, jl), (tt, tl) = _pool(dtype,
                                                               n_rep)
    want = j_paged.paged_decode_attention(jq, (jkc, jvc), jt, jl,
                                          block_size=BS, n_rep=n_rep)
    got = t_paged.paged_decode_attention(tq, (tkc, tvc), tt, tl,
                                         block_size=BS, n_rep=n_rep)
    assert torch.isfinite(got.float()).all()
    _close(got, want, tol)


@functools.lru_cache(maxsize=None)
def _jax_fwd(block_q, block_k):
    # one compiled interpret-mode kernel per block shape
    return jax.jit(lambda q, k, v: j_flash._fwd(
        q, k, v, D ** -0.5, True, block_q, block_k, True))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", N_REP)
def test_k3_plain_matches_jax_fwd_tiling(dtype, tol, n_rep):
    """S = 32 over 8-row q tiles and 16-row k tiles: the Pallas kernel
    with its causal trip count (kv repeated for JAX, native GQA for the
    port)."""
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 32, H // n_rep, dtype)
    want_out, want_lse = _jax_fwd(8, 16)(
        jq, j_attn.repeat_kv(jk, n_rep), j_attn.repeat_kv(jv, n_rep))
    out, lse = t_flash.flash_attention(tq, tk, tv, causal=True)
    _close(out, want_out, tol)
    _close(lse, want_lse, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", N_REP)
def test_k3_plain_matches_jax_flash_not_tiling(dtype, tol, n_rep):
    """S = 20 does not tile 8-row blocks: JAX takes its XLA dense
    fallback, which the port's kernel replaces by masking the ragged
    tile itself."""
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 20, H // n_rep, dtype)
    want_out, (*_, want_lse) = j_flash._flash_fwd(
        jq, j_attn.repeat_kv(jk, n_rep), j_attn.repeat_kv(jv, n_rep),
        True, None, 8, 8, None)
    out, lse = t_flash.flash_attention(tq, tk, tv, causal=True)
    _close(out, want_out, tol)
    _close(lse, want_lse, tol)


def test_k3_plain_full_attention_matches_dense():
    """causal=False: the plain K3 version equals dense attention."""
    rng = np.random.default_rng(3)
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 10, 2, "float32")
    out, _ = t_flash.flash_attention(tq, tk, tv, causal=False)
    want = t_attn.dense_attention(tq, t_attn.repeat_kv(tk, 2),
                                  t_attn.repeat_kv(tv, 2), causal=False)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


# the chunk reads: empty, mid-block, block-aligned and per-slot prefixes
PREFIXES = [0, 9, 2 * BS, [0, 9, 25]]
SQ = 5         # chunk rows


def _chunk_inputs(dtype, n_rep, prefix, seed=4):
    """A pool, tables, a prefix length and a chunk's q/K/V in both
    frameworks, plus the JAX gathered ``[B, P+S]`` K/V (prefix pages
    then the chunk) that ``chunk_attention`` reads."""
    rng = np.random.default_rng(seed)
    B, kv, N = 3, H // n_rep, 12
    kc = rng.normal(size=(N, BS, kv, D)).astype(np.float32)
    vc = rng.normal(size=(N, BS, kv, D)).astype(np.float32)
    q = rng.normal(size=(B, SQ, H, D)).astype(np.float32)
    kch = rng.normal(size=(B, SQ, kv, D)).astype(np.float32)
    vch = rng.normal(size=(B, SQ, kv, D)).astype(np.float32)
    tables = rng.integers(0, N, size=(B, BPS)).astype(np.int32)
    j, t = zip(*(_both(x, dtype) for x in (q, kc, vc, kch, vch)))
    if isinstance(prefix, list):
        j_plen = jnp.asarray(prefix, jnp.int32)
        t_plen = torch.tensor(prefix, dtype=torch.int32)
    else:
        j_plen = t_plen = prefix
    jtab, ttab = jnp.asarray(tables), torch.from_numpy(tables)
    return (j, jtab, j_plen), (t, ttab, t_plen)


def _gathered(pool, tables, chunk, xp_cat):
    B = tables.shape[0]
    return xp_cat([pool[tables].reshape(B, BPS * BS, -1, D), chunk])


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_chunk_attention_matches_jax(dtype, tol, n_rep, prefix):
    """The gather-semantics chunk read, two-part mask included."""
    ((jq, jkc, jvc, jkch, jvch), jt, jp), \
        ((tq, tkc, tvc, tkch, tvch), tt, tp) = _chunk_inputs(dtype, n_rep,
                                                             prefix)
    jcat = functools.partial(jnp.concatenate, axis=1)
    tcat = functools.partial(torch.cat, dim=1)
    want = j_attn.chunk_attention(
        jq, j_attn.repeat_kv(_gathered(jkc, jt, jkch, jcat), n_rep),
        j_attn.repeat_kv(_gathered(jvc, jt, jvch, jcat), n_rep), jp)
    tt = tt.long()
    got = t_attn.chunk_attention(
        tq, t_attn.repeat_kv(_gathered(tkc, tt, tkch, tcat), n_rep),
        t_attn.repeat_kv(_gathered(tvc, tt, tvch, tcat), n_rep), tp)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_paged_chunk_stream_matches_jax(dtype, tol, n_rep, prefix):
    ((jq, jkc, jvc, jkch, jvch), jt, jp), \
        ((tq, tkc, tvc, tkch, tvch), tt, tp) = _chunk_inputs(dtype, n_rep,
                                                             prefix)
    want = j_attn.paged_chunk_attention(jq, (jkc, jvc), jt, jp, jkch, jvch,
                                        block_size=BS, n_rep=n_rep)
    got = t_attn.paged_chunk_attention(tq, (tkc, tvc), tt, tp, tkch, tvch,
                                       block_size=BS, n_rep=n_rep)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_k2_plain_matches_jax_kernel(dtype, tol, n_rep, prefix):
    """The K2 plain version, and the wrapper on CPU tensors (which takes
    it and counts no launch), against the Pallas chunk kernel in
    interpret mode."""
    ((jq, jkc, jvc, jkch, jvch), jt, jp), \
        ((tq, tkc, tvc, tkch, tvch), tt, tp) = _chunk_inputs(dtype, n_rep,
                                                             prefix)
    want = j_paged.paged_chunk_attention(jq, (jkc, jvc), jt, jp, jkch,
                                         jvch, block_size=BS, n_rep=n_rep)
    kw = dict(block_size=BS, n_rep=n_rep)
    plain = t_paged.paged_chunk_reference(tq, (tkc, tvc), tt, tp, tkch,
                                          tvch, **kw)
    before = t_paged.paged_chunk_attention.launches
    got = t_paged.paged_chunk_attention(tq, (tkc, tvc), tt, tp, tkch, tvch,
                                        **kw)
    assert t_paged.paged_chunk_attention.launches == before
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    _close(got, want, tol)


def test_k2_plain_with_an_empty_prefix_ignores_the_table():
    """Prefix 0 reads no page: a table of out-of-range ids changes
    nothing (the first chunk of every chunked prefill)."""
    (_, _, _), ((tq, tkc, tvc, tkch, tvch), tt, _) = _chunk_inputs(
        "float32", 2, 0)
    kw = dict(block_size=BS, n_rep=2)
    junk = torch.full_like(tt, 10 ** 6)
    got = t_paged.paged_chunk_reference(tq, (tkc, tvc), junk, 0, tkch,
                                        tvch, **kw)
    want = t_attn.dense_attention(tq, t_attn.repeat_kv(tkch, 2),
                                  t_attn.repeat_kv(tvch, 2))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
