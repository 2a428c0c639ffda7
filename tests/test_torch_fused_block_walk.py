"""The bf16 K8's tile walk, its arithmetic emulated on the CPU.

On the card the fused bottleneck (``csrc/fused_block.cu``) runs one
thread block of 8 warps per (band of ``R`` output rows, image):

- phase A computes ``c1 = relu(x·W1 + b1)`` for the image rows ``r0 - 1
  .. r0 + R`` that lie inside the image only, their pixels counted from
  the first such row, into a zero plane indexed over the PADDED width
  (``p = y·(W+2) + x``, the halo columns and the rows outside the image
  left zero);
- phase B reads the 3×3's A operand straight from that plane at nine row
  shifts ``dy·(W+2) + dx`` (taps ``dy`` major), one shift a staged step,
  into ``c2`` over the padded-width pixels of the band's rows inside the
  image, rounded up to 16;
- phase C computes ``y = relu(c2·W3 + b3 + x)`` over the same rows and
  stores only real pixels of real rows.

Each product runs in ``BM × BN`` output tiles of 8 warps of ``WM × 64``,
reduction steps ``DEPTH`` deep (phase A at most 64), 16-row fragments at
or past a tile's ``rows_lim`` skipped, and every tile's epilogue reads
its sums from the m16n8k16 C fragments: lane ``(g, t)`` holds rows
``g`` and ``g + 8`` of a fragment at columns ``2t, 2t + 1`` of each
n-block of 8. The emulation below is kept here, independent of the
port: plain torch, the same walk, with the plane's overhang and the
unwritten ``c2`` and output poisoned with NaN so that a read the walk
should not make, or a write it misses or repeats, shows. It is held
against the JAX package's ``fused_bottleneck_eval`` with its Pallas
kernel in interpret mode (as ``tests/test_torch_fused_block.py`` runs
it) and against the port's ``matmul_chain_reference``.

Tolerances, of the reference's max |y|: fp32 1e-5 (reduction order
only); bf16 2e-2 (c1, c2 and y each rounded once to bf16, so a value
may round one unit apart where the fp32 sums straddle a boundary).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubeflow_tpu.compute.ops import fused_block as j_fused
from kubeflow_tpu_torch.compute.ops import fused_block as t_fused
from kubeflow_tpu_torch.compute.params import tree_from_jax

WARPS = 8
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (BM, BN) of the block's output tile, by M: what the kernel's plan takes
TILES = ((256, 64), (256, 128), (128, 256), (64, 256))


def tiles_for(m):
    return TILES[0] if m <= 64 else TILES[1] if m <= 128 else \
        TILES[2] if m <= 256 else TILES[3]


def depth_for(c, m):
    return 64 if c % 64 == 0 and m % 64 == 0 else 32


def fragment_map(bm, bn):
    """Row and column of every C-fragment register of the block's warps:
    ``[warp, fragment, n-block, lane, register]`` index arrays."""
    warps_n = bn // 64
    wm = bm // (WARPS // warps_n)
    warp = torch.arange(WARPS).view(-1, 1, 1, 1, 1)
    frag = torch.arange(wm // 16).view(1, -1, 1, 1, 1)
    nblk = torch.arange(8).view(1, 1, -1, 1, 1)
    lane = torch.arange(32).view(1, 1, 1, -1, 1)
    reg = torch.arange(4).view(1, 1, 1, 1, -1)
    g, t = lane // 4, lane % 4
    rows = (warp // warps_n) * wm + 16 * frag + g + 8 * (reg // 2)
    cols = (warp % warps_n) * 64 + 8 * nblk + 2 * t + reg % 2
    shape = (WARPS, wm // 16, 8, 32, 4)
    return rows.expand(shape), cols.expand(shape)


def _gemm(a_of, b, k_total, depth, bm, bn, rows_lim):
    """A BM × BN tile's fp32 sums over ``k_total`` in staged steps of
    ``depth``, one k16 slice at a time; ``a_of(k0)`` is the step's A
    window ``[BM, depth]``. 16-row fragments starting at or past
    ``rows_lim`` are skipped (their sums stay 0)."""
    active = (torch.arange(bm) // 16 * 16) < rows_lim
    acc = torch.zeros((bm, bn))
    for k0 in range(0, k_total, depth):
        a = a_of(k0)[active].float()
        for p in range(0, depth, 16):
            acc[active] += a[:, p:p + 16] @ b[k0 + p:k0 + p + 16].float()
    return acc


def _pairs(acc, bm, bn):
    """The tile's sums as the epilogue sees them, one bf16x2 word each:
    ``(row, first column, [v0, v1])`` for registers (0, 1) and (2, 3) of
    every lane."""
    rows, cols = fragment_map(bm, bn)
    vals = acc[rows, cols]
    return (rows[..., 0::2].reshape(-1), cols[..., 0::2].reshape(-1),
            torch.stack([vals[..., 0::2].reshape(-1),
                         vals[..., 1::2].reshape(-1)], dim=-1))


def _pair(t, col, row=None):
    """``t[col], t[col + 1]`` (``t[row, col]``, ... for a matrix) → [k, 2]."""
    cols = torch.stack([col, col + 1], dim=-1)
    return t[cols] if row is None else t[row.unsqueeze(-1), cols]


def _put(t, row, col, v, add=False):
    """``t[row, col:col + 2] = v`` for every word at once."""
    rows = row.unsqueeze(-1).expand(-1, 2)
    cols = torch.stack([col, col + 1], dim=-1)
    t.index_put_((rows.reshape(-1), cols.reshape(-1)), v.reshape(-1),
                 accumulate=add)


def _pad_cols(w, n):
    """Weight columns past the matrix read as zero (the kernel's copy)."""
    return torch.nn.functional.pad(w, (0, n - w.shape[1]))


def emulate(x, w1, b1, w2, b2, w3, b3, band, bm, bn, depth):
    """The kernel's walk over x ``[N, H, W, C]`` with folded operands
    (``folded_operands``' layout) → y in x's dtype."""
    dt = x.dtype
    n, h, w, c = x.shape
    m = w1.shape[1]
    w2 = w2.reshape(9 * m, m)
    da = min(depth, 64)
    wp = w + 2
    pixels = band * wp
    plane_rows = -(-pixels // 16) * 16 + 2 * wp + 2
    m_tiles, c_tiles = -(-m // bn), -(-c // bn)
    w1p, w2p = _pad_cols(w1, m_tiles * bn), _pad_cols(w2, m_tiles * bn)
    w3p = _pad_cols(w3, c_tiles * bn)
    nan = float("nan")
    out = torch.full((n, h, w, c), nan)
    writes = torch.zeros((n, h, w, c), dtype=torch.int32)

    def rnd(v):
        return v.to(dt).float()

    for img in range(n):
        for r0 in range(0, h, band):
            # rows of c2 that phases B and C compute: the band's rows
            # inside the image, in whole 16-row fragments
            rows = -(-min(band, h - r0) * wp // 16) * 16
            # the plane, with NaN rows past its end: a tap that reads
            # there would poison the result
            plane = torch.zeros((plane_rows + bm, m))
            plane[plane_rows:] = nan
            c2 = torch.full((rows, m), nan)
            # ---- phase A: the in-image rows lo .. hi - 1 only
            lo, hi = max(r0 - 1, 0), min(r0 + band + 1, h)
            q_rows = (hi - lo) * w
            y0 = lo - (r0 - 1)
            xa = x[img, lo:hi].reshape(q_rows, c)
            for row0 in range(0, q_rows, bm):
                staged = torch.zeros((bm, c), dtype=dt)    # zero-filled rows
                staged[:min(bm, q_rows - row0)] = xa[row0:row0 + bm]
                for nt in range(m_tiles):
                    n0 = nt * bn
                    acc = _gemm(lambda k0: staged[:, k0:k0 + da],
                                w1p[:, n0:n0 + bn], c, da, bm, bn,
                                q_rows - row0)
                    r, col, v = _pairs(acc, bm, bn)
                    q, col = row0 + r, n0 + col
                    keep = (q < q_rows) & (col < m)
                    q, col, v = q[keep], col[keep], v[keep]
                    _put(plane, (y0 + q // w) * wp + q % w + 1, col,
                         rnd(torch.relu(v + _pair(b1, col))))
            # ---- phase B: A straight from the plane at the tap's shift
            for row0 in range(0, rows, bm):
                for nt in range(m_tiles):
                    n0 = nt * bn

                    def window(k0, row0=row0):
                        tap = k0 // m                 # depth divides M
                        shift = (tap // 3) * wp + tap % 3
                        col0 = k0 - tap * m
                        return plane[row0 + shift:row0 + shift + bm,
                                     col0:col0 + depth]

                    acc = _gemm(window, w2p[:, n0:n0 + bn], 9 * m, depth,
                                bm, bn, rows - row0)
                    r, col, v = _pairs(acc, bm, bn)
                    p, col = row0 + r, n0 + col
                    keep = (p < rows) & (col < m)
                    p, col, v = p[keep], col[keep], v[keep]
                    _put(c2, p, col, rnd(torch.relu(v + _pair(b2, col))))
            # ---- phase C: A from c2; real pixels of real rows stored
            c2p = torch.cat([c2, torch.full((bm, m), nan)])
            for row0 in range(0, rows, bm):
                for nt in range(c_tiles):
                    n0 = nt * bn
                    acc = _gemm(lambda k0: c2p[row0:row0 + bm,
                                               k0:k0 + depth],
                                w3p[:, n0:n0 + bn], m, depth, bm, bn,
                                rows - row0)
                    r, col, v = _pairs(acc, bm, bn)
                    p, col = row0 + r, n0 + col
                    y, xx = p // wp, p % wp
                    keep = (p < pixels) & (xx < w) & (r0 + y < h) & (col < c)
                    y, xx, col, v = y[keep], xx[keep], col[keep], v[keep]
                    pix = (img * h + r0 + y) * w + xx      # flat pixel
                    flat_x = x.reshape(-1, c)
                    v = v + _pair(b3, col) + _pair(flat_x, col, pix).float()
                    _put(out.view(-1, c), pix, col, rnd(torch.relu(v)))
                    _put(writes.view(-1, c), pix, col,
                         torch.ones_like(v, dtype=torch.int32), add=True)
    assert torch.equal(writes, torch.ones_like(writes)), \
        "every output is written exactly once"
    return out.to(dt)


def make_block(c, m, seed):
    """An identity bottleneck's ``(params, stats)`` as numpy trees in the
    JAX layout, every BN quantity randomised."""
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


@functools.lru_cache(maxsize=None)
def case(shape, dtype):
    """One draw → (x, folded operands, JAX's result as fp32 numpy)."""
    n, h, w, c, m = shape
    bp, bs = make_block(c, m, seed=h * 31 + w * 7 + c + m)
    x = np.random.default_rng(n + h + w).standard_normal(
        (n, h, w, c)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(j_fused.fused_bottleneck_eval(
        jnp.asarray(x, jdt), tree_map_j(bp), tree_map_j(bs)).astype(
            jnp.float32))
    tdt = getattr(torch, dtype)
    ops = t_fused.folded_operands(tree_from_jax(bp, device="cpu"),
                                  tree_from_jax(bs, device="cpu"), tdt)
    return torch.from_numpy(x).to(tdt), ops, want


def tree_map_j(tree):
    if isinstance(tree, dict):
        return {k: tree_map_j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def check(shape, dtype, band, bm, bn, depth):
    x, ops, want = case(shape, dtype)
    got = emulate(x, *ops, band=band, bm=bm, bn=bn, depth=depth)
    assert got.dtype == x.dtype and got.shape == x.shape
    got = got.float()
    assert torch.isfinite(got).all()
    scale = float(np.abs(want).max())
    assert scale > 0.5          # randomised BN: more than relu(x) of zeros
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL[dtype] * scale, (err, scale)
    ref = t_fused.matmul_chain_reference(x, *ops).float()
    err_ref = float((got - ref).abs().max())
    assert err_ref <= TOL[dtype] * scale, (err_ref, scale)


# (n, H, W, C, M): C = 4M and C = M, M 32 and 64, W 5, 7 and 9, a 1x1
# image; batch at most 2
SHAPES = [(2, 7, 7, 128, 32), (1, 5, 5, 64, 64), (2, 6, 9, 256, 64),
          (1, 9, 5, 32, 32), (1, 1, 1, 32, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,band", [
    (s, b) for s in SHAPES for b in sorted({1, 2, 3, s[1]}) if b <= s[1]])
def test_walk_matches_jax_at_every_band(shape, band, dtype):
    """Bands of 1, 2, 3 rows (ragged last bands where they do not divide
    H) and the whole image, at the tile and depth the plan takes."""
    _, _, _, c, m = shape
    check(shape, dtype, band, *tiles_for(m), depth_for(c, m))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("depth", [32, 64])
def test_walk_every_tile_and_depth(tile, depth, dtype):
    """Each of the four block tiles at both step depths, on a plane whose
    9 rows of 9 are two bands, the second ragged."""
    check((1, 9, 9, 128, 64), dtype, 5, *tile, depth)


@pytest.mark.parametrize("tile", TILES)
def test_fragment_map_covers_each_tile_output_once(tile):
    bm, bn = tile
    rows, cols = fragment_map(bm, bn)
    hits = torch.zeros((bm, bn), dtype=torch.int32)
    hits.index_put_((rows.reshape(-1), cols.reshape(-1)),
                    torch.ones(rows.numel(), dtype=torch.int32),
                    accumulate=True)
    assert torch.equal(hits, torch.ones_like(hits))
    # a lane's pairs are two adjacent columns of one row: one bf16x2 word
    r, c = rows[..., 0::2], cols[..., 0::2]
    assert torch.equal(rows[..., 1::2], r) and torch.equal(
        cols[..., 1::2], c + 1)
    assert bool((c % 2 == 0).all())


@pytest.mark.parametrize("h,band", [(7, 7), (14, 7), (14, 8), (56, 8),
                                    (11, 3)])
def test_phase_a_rows_lie_inside_the_image(h, band):
    """Phase A's rows: the band's halo rows only where the image has
    them; every image row's c1 is computed by the band that owns the row
    and by the bands that need it as a halo, never for a row outside."""
    need = torch.zeros(h, dtype=torch.int32)
    for r0 in range(0, h, band):
        lo, hi = max(r0 - 1, 0), min(r0 + band + 1, h)
        assert 0 <= lo < hi <= h
        need[lo:hi] += 1
        # what a band's output rows read of c1: their rows +- 1 inside
        for y in range(r0, min(r0 + band, h)):
            assert lo <= max(y - 1, 0) and min(y + 1, h - 1) < hi
    assert bool((need >= 1).all())
