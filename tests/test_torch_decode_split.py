"""K1's split key walk (flash-decoding), its arithmetic emulated on the CPU.

On the card the decode read (``csrc/paged_decode.cu``) splits each
(slot, kv head)'s key walk over several blocks: the table's ``n =
ceil(bps·bs / 32)`` tiles of 32 positions are cut into ``splits`` spans,
split ``i`` taking the tiles ``[i·n // splits, (i+1)·n // splits)``. A
split folds its tiles one after another into an online softmax (fp32 m,
l and accumulator, p kept in fp32 for p·V) and leaves a partial ``(m,
l, acc)``; a split whose span starts at or past the slot's length reads
nothing and leaves ``m = -1e30, l = 0, acc = 0``. A second kernel merges
the partials in split order, each scaled by ``exp(m_i - m_max)``,
divides once with the ``l == 0 → 1`` guard and rounds once to q's dtype.
The emulation below is kept here, independent of the port: plain torch
over the same inputs, fp32 and bf16, float and int8 pages
(``kv_quantize``), GQA groups of 1 and 4, lengths 0, 1, mid-page and the
full table, 1, 3 and ``n`` splits (3 and ``n`` leave splits wholly past a
short slot's length). It is held against the JAX Pallas decode kernel
in interpret mode (as ``test_torch_attention`` and ``test_torch_int8_kv``
run it) and against the port's plain version; ``decode_splits``, the
wrapper's rule, is held at the serving shapes, and the profiler's kernel
groups take the combine kernel into K1's.

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
from kubeflow_tpu_torch.compute import profiler as t_prof
from kubeflow_tpu_torch.compute.ops import paged_attention as t_paged

j_paged = importlib.import_module("kubeflow_tpu.compute.ops.paged_attention")

NEG_INF = -1e30
TILE = 32                      # the kernel's tile of positions
H, D = 4, 16
BS, BPS, N = 8, 24, 64         # a table of 192 positions: 6 tiles
N_TILES = BPS * BS // TILE
LENGTHS = [0, 1, 37, BPS * BS]  # empty, one position, mid-page, full


def _t(a):
    """A numpy / JAX array → a CPU tensor, bf16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _case(dtype, n_rep, int8, seed=11):
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
    S = len(LENGTHS)
    q = jnp.asarray(rng.normal(size=(S, 1, H, D)), jdt)
    tables = rng.integers(0, N, size=(S, BPS)).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    jargs = (q, jpages, jnp.asarray(tables), jnp.asarray(lengths))
    targs = (_t(q), tuple(_t(p) for p in jpages), torch.from_numpy(tables),
             torch.from_numpy(lengths))
    return jargs, targs


def _widen(pages, slot, kvh, tables, length, dtype):
    """Slot ``slot``'s K and V of kv head ``kvh`` as fp32 rows: int8
    codes times their fp32 scale in fp32, rounded once to q's dtype."""
    rows = [(int(tables[slot, p // BS]), p % BS) for p in range(length)]
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


def _split_partial(rows, keys, vals, lo, hi):
    """One split's walk over positions [lo, hi): tile by tile, the
    online fold → (m, l, acc); an empty span → the empty partial."""
    m = torch.full((rows.shape[0], 1), NEG_INF)
    l = torch.zeros((rows.shape[0], 1))
    acc = torch.zeros((rows.shape[0], D))
    for b in range(lo, hi, TILE):
        e = min(b + TILE, hi)
        s = rows @ keys[b:e].T
        m_new = torch.maximum(m, s.max(1, keepdim=True).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(1, keepdim=True)
        acc = acc * corr + p @ vals[b:e]
        m = m_new
    return m, l, acc


def split_walk(q, pages, tables, lengths, *, n_rep, splits):
    """The split walk's arithmetic → ``[S, 1, H, D]`` in q's dtype."""
    dtype = q.dtype
    kv = H // n_rep
    qs = (q.float() * D ** -0.5).to(dtype).float()   # the wrapper's prescale
    out = torch.empty(q.shape, dtype=dtype)
    for slot in range(q.shape[0]):
        length = min(max(int(lengths[slot]), 0), BPS * BS)
        for kvh in range(kv):
            keys, vals = _widen(pages, slot, kvh, tables, length, dtype)
            heads = slice(kvh * n_rep, (kvh + 1) * n_rep)
            rows = qs[slot, 0, heads]
            parts = []
            for i in range(splits):
                lo = i * N_TILES // splits * TILE
                hi = min((i + 1) * N_TILES // splits * TILE, length)
                parts.append(_split_partial(rows, keys, vals, lo, hi))
            m_max = torch.stack([m for m, _, _ in parts]).amax(0)
            l = sum(torch.exp(m - m_max) * l for m, l, _ in parts)
            acc = sum(torch.exp(m - m_max) * a for m, _, a in parts)
            out[slot, 0, heads] = (acc / torch.where(l == 0, 1.0, l)).to(
                dtype)
    return out


@functools.lru_cache(maxsize=None)
def _references(dtype, n_rep, int8):
    """The inputs, the JAX kernel's output and the port's plain
    version's, once for all the split counts of one draw."""
    jargs, targs = _case(dtype, n_rep, int8)
    want = j_paged.paged_decode_attention(*jargs, block_size=BS,
                                          n_rep=n_rep)
    plain = t_paged.paged_decode_reference(*targs, block_size=BS,
                                           n_rep=n_rep)
    return targs, np.asarray(want, np.float32), plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("splits", [1, 3, N_TILES])
def test_split_walk_matches_jax_kernel(dtype, int8, n_rep, splits):
    """Lengths 0, 1, 37 and the full table; 3 and 6 splits leave the
    short slots' later splits wholly past their lengths."""
    targs, want, plain = _references(dtype, n_rep, int8)
    got = split_walk(*targs, n_rep=n_rep, splits=splits)
    assert got.dtype == getattr(torch, dtype)
    assert torch.isfinite(got.float()).all()
    assert not got[0].float().abs().max()          # length 0 reads nothing
    tol = 1e-5 if dtype == "float32" else 0.02
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)
    if dtype == "float32":
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), plain.float(), atol=1e-6,
                                   rtol=2 ** -7)


def test_one_split_is_the_whole_walk():
    """One split is the unsplit fold: the merge of one partial changes
    no bit (its weight is exp(0) = 1)."""
    targs, _, _ = _references("float32", 4, False)
    one = split_walk(*targs, n_rep=4, splits=1)
    q, pages, tables, lengths = targs
    qs = (q.float() * D ** -0.5).float()
    for slot, length in enumerate(LENGTHS):
        for kvh in range(H // 4):
            keys, vals = _widen(pages, slot, kvh, tables, length,
                                torch.float32)
            m, l, acc = _split_partial(qs[slot, 0, kvh * 4:kvh * 4 + 4],
                                       keys, vals, 0, length)
            assert torch.equal(one[slot, 0, kvh * 4:kvh * 4 + 4],
                               acc / torch.where(l == 0, 1.0, l))


# the serving shapes of chip_smoke.py: 8 q / 2 kv heads, block 16, 64
# blocks a slot (a table of 32 tiles), on a card of 132 SMs
SMS = 132


@pytest.mark.parametrize("slots", [1, 2, 4, 8])
def test_decode_splits_fill_the_card_at_the_serving_shapes(slots):
    splits = t_paged.decode_splits(slots, 2, 16, 64, SMS)
    blocks = slots * 2
    assert 1 < splits <= 32
    assert blocks * splits >= SMS or splits == 32
    assert blocks * (splits - 1) < 2 * SMS          # about twice, no more


def test_decode_splits_at_the_named_shapes():
    # chip_smoke.py's decode shape: 17 splits, 272 blocks
    assert t_paged.decode_splits(8, 2, 16, 64, SMS) == 17
    # one lone slot takes the most: one split a tile
    assert t_paged.decode_splits(1, 2, 16, 64, SMS) == 32
    assert t_paged.decode_splits(1, 1, 16, 64, SMS) == 32
    # a grid that already fills the card takes one
    assert t_paged.decode_splits(64, 8, 16, 64, SMS) == 1
    assert t_paged.decode_splits(132, 2, 16, 64, SMS) == 1
    assert t_paged.decode_splits(0, 2, 16, 64, SMS) == 1
    # never more splits than tiles: 3 positions are one tile
    assert t_paged.decode_splits(1, 1, 1, 3, SMS) == 1
    assert t_paged.decode_splits(1, 1, 16, 3, SMS) == math.ceil(48 / TILE)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::paged_decode_combine_kernel"
     "<__nv_bfloat16, 128>", "K1 paged_decode"),
    ("void (anonymous namespace)::paged_decode_combine_kernel<float, 64>",
     "K1 paged_decode"),
    ("void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, "
     "signed char, 128>", "K1 paged_decode"),
    ("void (anonymous namespace)::paged_chunk_combine_kernel<128>",
     "K2 paged_chunk")])
def test_profiler_groups_the_combine_kernels(name, group):
    assert t_prof.kernel_group(name) == group
