"""The bf16 K2's split key walk, its arithmetic emulated on the CPU.

On the card the bf16 chunk read (``csrc/paged_chunk.cu``) splits each
64-row query tile's key walk over several blocks: split ``i`` of a walk
of ``n`` key tiles takes the tiles ``[i·n // splits, (i+1)·n //
splits)`` and leaves a partial ``(m, l, acc)`` in fp32 (a split with no
key leaves ``m = -1e30, l = 0, acc = 0``), with ``p`` entering ``p·V``
as ``bf16(p) + bf16(p - bf16(p))``; a second kernel merges the partials
in split order, each scaled by ``exp(m_i - m_max)``, divides once with
the ``l == 0 → 1`` guard and rounds once. The emulation below is kept
here, independent of the port: plain torch over the same inputs, fp32
(``p`` as it is) and bf16 (``p`` split into hi + lo), float and int8
pages, splits with no key and an empty prefix. It is held against the
JAX Pallas chunk kernel in interpret mode (as ``test_torch_attention``
and ``test_torch_int8_kv`` run it) and against the port's plain
version; ``chunk_splits``, the wrapper's rule, is held at the serving
shapes.

Tolerances: against JAX fp32 1e-5 (reduction order only), bf16 0.02
(the paged-read tolerance of ``tests/test_paged_attention.py``);
against the port's plain version fp32 1e-5 and bf16 one unit in the
last place (2⁻⁷ relative: both sum in fp32 and round once, so they
differ only where the fp32 values straddle a rounding boundary).
"""

import functools
import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubeflow_tpu.compute import quantize as jq
from kubeflow_tpu_torch.compute.ops import paged_attention as t_paged

j_paged = importlib.import_module("kubeflow_tpu.compute.ops.paged_attention")

NEG_INF = -1e30
ROW_TILE = 64
B, S, H, D = 3, 40, 4, 16
BS, BPS, N = 8, 10, 32
PREFIX = [0, 37, BPS * BS]   # chunk keys only, mid-block, the full table


def _t(a):
    """A numpy / JAX array → a CPU tensor, bf16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _case(dtype, n_rep, prefix, int8, seed=7):
    """One draw in both frameworks: (jax args, torch args)."""
    rng = np.random.default_rng(seed)
    jdt = getattr(jnp, dtype)
    kv = H // n_rep
    kc, vc = (jnp.asarray(rng.normal(size=(N, BS, kv, D)) * 2, jdt)
              for _ in range(2))
    if int8:
        (kq, ks), (vq, vs) = jq.kv_quantize(kc), jq.kv_quantize(vc)
        jpages = (kq, vq, ks, vs)
    else:
        jpages = (kc, vc)
    q = jnp.asarray(rng.normal(size=(B, S, H, D)), jdt)
    kch, vch = (jnp.asarray(rng.normal(size=(B, S, kv, D)), jdt)
                for _ in range(2))
    tables = rng.integers(0, N, size=(B, BPS)).astype(np.int32)
    plen = np.asarray(prefix, np.int32)
    jargs = (q, jpages, jnp.asarray(tables), jnp.asarray(plen), kch, vch)
    targs = (_t(q), tuple(_t(p) for p in jpages), torch.from_numpy(tables),
             torch.from_numpy(plen), _t(kch), _t(vch))
    return jargs, targs


def _widen(pages, b, kvh, tables, plen, dtype):
    """Slot b's prefix K and V of kv head kvh as fp32 rows: int8 codes
    times their fp32 scale in fp32, rounded once to q's dtype."""
    rows = [(int(tables[b, p // BS]), p % BS) for p in range(plen)]
    out = []
    for i in (0, 1):
        x = torch.stack([pages[i][blk, r, kvh] for blk, r in rows]) \
            if rows else torch.zeros((0, D), dtype=pages[i].dtype)
        if len(pages) == 4:
            scale = torch.stack([pages[2 + i][blk, r, kvh]
                                 for blk, r in rows]) if rows else \
                torch.zeros((0, 1))
            x = (x.float() * scale).to(dtype)
        out.append(x.float())
    return out


def _pv(p, v, split_p):
    if not split_p:
        return p @ v
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    return hi @ v + lo @ v


def split_walk(q, pages, tables, plen, kch, vch, *, n_rep, splits,
               key_tile):
    """The split walk's arithmetic → ``[B, S, H, D]`` in q's dtype."""
    dtype = q.dtype
    split_p = dtype == torch.bfloat16
    kv = H // n_rep
    qs = (q.float() * D ** -0.5).to(dtype).float()   # the wrapper's prescale
    out = torch.empty(q.shape, dtype=dtype)
    per_tile = ROW_TILE // n_rep
    for b in range(B):
        pl = int(plen[b])
        for kvh in range(kv):
            kp, vp = _widen(pages, b, kvh, tables, pl, dtype)
            for s0 in range(0, S, per_tile):
                s1 = min(S, s0 + per_tile)
                keys = torch.cat([kp, kch[b, :s1, kvh].float()])
                vals = torch.cat([vp, vch[b, :s1, kvh].float()])
                # rows position-major, a GQA group's heads adjacent
                heads = [kvh * n_rep + r for r in range(n_rep)]
                rows = qs[b, s0:s1][:, heads].reshape(-1, D)
                qpos = torch.arange(s0, s1).repeat_interleave(n_rep)
                col = torch.arange(keys.shape[0])
                valid = (col[None] < pl) | (col[None] - pl <= qpos[:, None])
                scores = torch.where(valid, rows @ keys.T,
                                     torch.tensor(NEG_INF))
                n_kt = -(-keys.shape[0] // key_tile)
                parts = []
                for i in range(splits):
                    lo = i * n_kt // splits * key_tile
                    hi = min((i + 1) * n_kt // splits * key_tile,
                             keys.shape[0])
                    sc, ok = scores[:, lo:hi], valid[:, lo:hi]
                    m = torch.full((rows.shape[0], 1), NEG_INF)
                    if hi > lo:
                        m = torch.maximum(m, sc.max(1, keepdim=True).values)
                    p = torch.where(ok, torch.exp(sc - m), 0.0)
                    parts.append((m, p.sum(1, keepdim=True),
                                  _pv(p, vals[lo:hi], split_p)))
                m_max = torch.stack([m for m, _, _ in parts]).amax(0)
                l = sum(torch.exp(m - m_max) * l for m, l, _ in parts)
                acc = sum(torch.exp(m - m_max) * a for m, _, a in parts)
                o = acc / torch.where(l == 0, 1.0, l)
                out[b, s0:s1][:, heads] = o.reshape(s1 - s0, n_rep, D).to(
                    dtype)
    return out


@functools.lru_cache(maxsize=None)
def _references(dtype, n_rep, prefix, int8):
    """The inputs, the JAX kernel's output and the port's plain version's,
    once for all the split counts of one draw."""
    jargs, targs = _case(dtype, n_rep, list(prefix), int8)
    want = j_paged.paged_chunk_attention(*jargs, block_size=BS, n_rep=n_rep)
    plain = t_paged.paged_chunk_reference(*targs, block_size=BS,
                                          n_rep=n_rep)
    return targs, np.asarray(want, np.float32), plain


def _check(dtype, n_rep, prefix, int8, splits, key_tile):
    targs, want, plain = _references(dtype, n_rep, tuple(prefix), int8)
    got = split_walk(*targs, n_rep=n_rep, splits=splits, key_tile=key_tile)
    assert got.dtype == getattr(torch, dtype)
    assert torch.isfinite(got.float()).all()
    tol = 1e-5 if dtype == "float32" else 0.02
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)
    if dtype == "float32":
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), plain.float(), atol=1e-6,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("splits,key_tile", [(3, 64), (8, 16)])
def test_split_walk_matches_jax_kernel(dtype, int8, n_rep, splits,
                                       key_tile):
    """Per-slot prefixes 0, 37 and the full table; 8 splits of 16-key
    tiles leave the slot with no prefix splits with no key."""
    _check(dtype, n_rep, PREFIX, int8, splits, key_tile)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_split_walk_with_an_empty_prefix(dtype, int8):
    """Prefix 0 everywhere (a chunked prefill's first chunk): the walk
    is the chunk's own causal keys, most of the 5 splits hold none."""
    _check(dtype, 4, [0, 0, 0], int8, 5, 64)


# the serving sites of chip_smoke.py (slots, chunk rows), 8 q / 2 kv
# heads, block 16, 64 blocks a slot, on a card of 132 SMs
SITES = {"prefill_chunk": (1, 256), "prefix_hit": (1, 64), "verify": (8, 5)}


@pytest.mark.parametrize("site", sorted(SITES))
def test_chunk_splits_fill_the_card_at_the_serving_sites(site):
    batch, seq = SITES[site]
    splits = t_paged.chunk_splits(batch, seq, 2, 4, 16, 64, 132)
    blocks = math.ceil(seq / (ROW_TILE // 4)) * 2 * batch
    assert splits > 1
    assert blocks * splits >= 132
    assert blocks * (splits - 1) < 2 * 132          # about twice, no more
    assert splits <= math.ceil((64 * 16 + seq) / 64)


def test_chunk_splits_take_one_where_the_grid_fills_the_card():
    assert t_paged.chunk_splits(64, 256, 2, 4, 16, 64, 132) == 1
    assert t_paged.chunk_splits(0, 5, 2, 4, 16, 64, 132) == 1
    # never more splits than key tiles in the longest walk
    assert t_paged.chunk_splits(1, 1, 1, 1, 1, 3, 132) == 1
