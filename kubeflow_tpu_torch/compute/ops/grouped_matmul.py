"""K6 and K7 — the block-diagonal grouped matmul behind dropless MoE and
its weight gradient, as hand-written CUDA kernels
(``csrc/grouped_matmul.cu``) beside their plain PyTorch versions.

Replace the Pallas TPU kernels of
``kubeflow_tpu/compute/ops/grouped_matmul.py``: ``_gmm_kernel`` (:44,
through ``_gmm_raw`` :86, K6) and ``_tgmm_kernel`` (:116, through
``_tgmm`` :151, K7), which JAX joins with the custom VJP ``gmm``
(:188-212) and this module with a ``torch.autograd.Function``.

Rows are laid out by :func:`padded_group_layout` so that every
``block_m``-row tile belongs to one expert (the megablocks layout); the
grouped product is then a block-diagonal matmul with a per-tile expert
id. :func:`grouped_matmul` (K6) computes ``out[i] = x[i] @
w[block_expert[i // block_m]]``, :func:`grouped_matmul_dw` (K7)
``dw[e] = Σ_{tiles of e} x_tileᵀ · dy_tile``. Each wrapper launches its
kernel for CUDA tensors and takes its plain version
(:func:`grouped_matmul_reference`, :func:`grouped_matmul_dw_reference`)
only for CPU tensors; on a CUDA tensor it launches or raises, never
falls back. Each counts its launches on itself:
``grouped_matmul.launches`` (K6) and ``grouped_matmul_dw.launches``
(K7).
"""

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' row tile: on the card ``block_m`` must be a multiple
ROW_TILE = 64
# tiles of weights gathered at once by the plain versions (bytes)
_CHUNK_BYTES = 1 << 28
_libs = {}


# ------------------------------------------------------------- layout

def padded_group_layout(key, n_groups, block_m):
    """Destination layout for megablocks dispatch
    (``grouped_matmul.py:217-255``), on the key's device with no host
    sync.

    ``key``: ``[rows]`` int group id per row (values in ``[0,
    n_groups)``). Returns ``(pos, block_expert, first, last, m_pad)``:
    ``pos[i]`` the destination row of source row ``i`` (groups
    contiguous from ``block_m``-aligned starts, stable within a group),
    ``block_expert[t]`` the group owning tile ``t`` (padding tiles after
    the last group keep the last id), ``first``/``last`` the int32 tile
    markers of each group's first and last tile, and the static
    ``m_pad = (ceil(rows / block_m) + n_groups) · block_m``. Every group
    gets at least one tile (an empty group's is all padding)."""
    dev = key.device
    rows = key.shape[0]
    m_pad = ((rows + block_m - 1) // block_m + n_groups) * block_m
    key = key.long()
    groups = torch.arange(n_groups, device=dev)
    # the one-hot is kept [groups, rows]: its cumsum then scans the
    # innermost dim (over the outer dim of [rows, groups], as JAX lays it
    # out, the card's scan kernel took ~2.8 ms for 16384 x 8)
    onehot = (groups[:, None] == key).to(torch.int32)
    counts = onehot.sum(1)
    padded = torch.clamp_min((counts + block_m - 1) // block_m, 1) * block_m
    starts = torch.cumsum(padded, 0) - padded
    # stable rank within the group: a one-hot cumsum, as JAX takes it
    rank = torch.cumsum(onehot, 1) - 1
    rank_i = torch.gather(rank, 0, key[None, :])[0]
    pos = (starts[key] + rank_i).to(torch.int32)

    n_tiles = m_pad // block_m
    tile_start = torch.arange(n_tiles, device=dev, dtype=starts.dtype) \
        * block_m
    ends = starts + padded
    block_expert = torch.searchsorted(ends, tile_start, right=True).clamp(
        0, n_groups - 1).to(torch.int32)
    first = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    last = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    first[starts // block_m] = 1
    last[(ends - 1) // block_m] = 1
    return pos, block_expert, first, last, int(m_pad)


def expert_tiles(block_expert, first, last, n_experts):
    """Each expert's row tiles as int32 ``[n_experts, 2]`` (first tile,
    one past the last), from the layout's ``first``/``last`` markers by
    device-side reductions (no host sync). Padding tiles after the last
    group's ``last`` marker fall outside every range, as in ``_tgmm``,
    whose accumulator is never flushed after it."""
    n_tiles = block_expert.shape[0]
    dev = block_expert.device
    t = torch.arange(n_tiles, device=dev)
    be = block_expert.long()
    start = torch.full((n_experts,), n_tiles, dtype=torch.long, device=dev)
    start.scatter_reduce_(0, be, torch.where(first.bool(), t, n_tiles),
                          reduce="amin")
    end = torch.zeros((n_experts,), dtype=torch.long, device=dev)
    end.scatter_reduce_(0, be, torch.where(last.bool(), t + 1, 0),
                        reduce="amax")
    return torch.stack([start, end], dim=1).to(torch.int32)


# ------------------------------------------------------- plain versions

def _chunk_tiles(k, n):
    return max(1, _CHUNK_BYTES // (4 * max(1, k * n)))


def grouped_matmul_reference(x, w, block_expert, block_m):
    """Plain version of K6, on any device: ``x [m, k]``, ``w [e, k, n]``
    (any strides), ``block_expert [m // block_m]`` → ``[m, n]`` in x's
    dtype. A per-tile ``bmm`` of fp32-widened operands over
    ``w[block_expert]``, a few tiles at a time (the gathered weights of
    every tile at once would be ``n_tiles·k·n`` values), each sum rounded
    once to x's dtype."""
    m, k = x.shape
    n = w.shape[2]
    n_tiles = m // block_m
    xt = x.reshape(n_tiles, block_m, k)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    step = _chunk_tiles(k, n)
    for t0 in range(0, n_tiles, step):
        be = block_expert[t0:t0 + step].long()
        prod = torch.bmm(xt[t0:t0 + step].float(), w[be].float())
        out[t0 * block_m:(t0 + be.shape[0]) * block_m] = prod.reshape(
            -1, n).to(x.dtype)
    return out


def grouped_matmul_dw_reference(x, dy, block_expert, first, last,
                                n_experts, block_m):
    """Plain version of K7, on any device: ``x [m, k]``, ``dy [m, n]`` →
    fp32 ``[n_experts, k, n]``: each tile's ``x_tileᵀ · dy_tile`` from
    fp32-widened operands summed into its expert (tiles outside every
    expert's ``first``..``last`` range add nothing)."""
    m, k = x.shape
    n = dy.shape[1]
    n_tiles = m // block_m
    tiles = expert_tiles(block_expert, first, last, n_experts).long()
    be = block_expert.long()
    t = torch.arange(n_tiles, device=x.device)
    live = ((t >= tiles[be, 0]) & (t < tiles[be, 1])).float()
    xt = x.reshape(n_tiles, block_m, k)
    dyt = dy.reshape(n_tiles, block_m, n)
    dw = torch.zeros((n_experts, k, n), dtype=torch.float32, device=x.device)
    step = _chunk_tiles(k, n)
    for t0 in range(0, n_tiles, step):
        sl = slice(t0, t0 + step)
        prod = torch.bmm(xt[sl].float().transpose(1, 2), dyt[sl].float())
        dw.index_add_(0, be[sl], prod * live[sl, None, None])
    return dw


# ------------------------------------------------------------- kernels

def _library():
    lib = _libs.get("grouped_matmul")
    if lib is not None:
        return lib
    lib = _build.load("grouped_matmul")
    lib.kubeflow_gmm.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
    lib.kubeflow_gmm.restype = ctypes.c_int
    lib.kubeflow_gmm_dw.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.kubeflow_gmm_dw.restype = ctypes.c_int
    _libs["grouped_matmul"] = lib
    return lib


def _check(x, other, block_expert, block_m, what):
    """Raise on what the kernels do not take (``other`` is w or dy)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES or other.dtype != x.dtype:
        raise TypeError(f"{what}: dtypes must be one of float32/bfloat16 "
                        f"and equal, got {x.dtype}, {other.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [m, k], got {tuple(x.shape)}")
    m = x.shape[0]
    if block_m % ROW_TILE or block_m < ROW_TILE:
        raise ValueError(
            f"{what}: block_m={block_m} (moe_gmm_block_m) must be a "
            f"multiple of {ROW_TILE}, the kernel's row tile: a tile may "
            f"not span two experts")
    if m % block_m:
        raise ValueError(f"{what}: {m} rows are not a multiple of "
                         f"block_m={block_m}")
    if block_expert.shape != (m // block_m,) or block_expert.is_floating_point():
        raise ValueError(f"{what}: block_expert must be int [m // block_m] "
                         f"= [{m // block_m}], got {block_expert.dtype} "
                         f"{tuple(block_expert.shape)}")
    if not (other.device == x.device == block_expert.device):
        raise ValueError(f"{what}: operands must be on one device")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def grouped_matmul(x, w, block_expert, block_m):
    """K6: ``out[i] = x[i] @ w[block_expert[i // block_m]]`` → ``[m, n]``
    in x's dtype, fp32 sums rounded once. ``x [m, k]``, ``w [e, k, n]``:
    contiguous, or the ``transpose(1, 2)`` view of a contiguous ``[e, n,
    k]`` tensor, which the kernel reads through its strides (the
    backward's dx) without a copy. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, block_expert, block_m)
    _check(x, w, block_expert, block_m, "grouped_matmul")
    if w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_matmul: w must be [e, k, n] with k = "
                         f"{x.shape[1]}, got {tuple(w.shape)}")
    trans = not w.is_contiguous() and w.transpose(1, 2).is_contiguous()
    base = w.transpose(1, 2) if trans else w.contiguous()
    x = x.contiguous()
    be = block_expert.to(torch.int32).contiguous()
    m, k = x.shape
    e, _, n = w.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.check_aligned(x, base, out)
    with torch.cuda.device(x.device):
        err = _library().kubeflow_gmm(
            x.data_ptr(), base.data_ptr(), be.data_ptr(), out.data_ptr(),
            m, k, n, e, block_m, int(trans), _DTYPE_CODES[x.dtype],
            _stream(x))
    if err:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA "
                           f"error {err}")
    grouped_matmul.launches += 1
    return out


def grouped_matmul_dw(x, dy, block_expert, first, last, n_experts, block_m):
    """K7: ``dw[e] = Σ_{tiles of e} x_tileᵀ · dy_tile`` → fp32
    ``[n_experts, k, n]``, from ``x [m, k]`` and ``dy [m, n]`` in one
    dtype and the layout's ``block_expert``/``first``/``last``. Each
    expert's tile range comes from the markers on the device
    (:func:`expert_tiles`); an empty expert's zero tile gives zeros. CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return grouped_matmul_dw_reference(x, dy, block_expert, first, last,
                                           n_experts, block_m)
    _check(x, dy, block_expert, block_m, "grouped_matmul_dw")
    if dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"grouped_matmul_dw: dy must be [m, n] with m = "
                         f"{x.shape[0]}, got {tuple(dy.shape)}")
    x = x.contiguous()
    dy = dy.contiguous()
    tiles = expert_tiles(block_expert, first, last, n_experts).contiguous()
    m, k = x.shape
    n = dy.shape[1]
    dw = torch.empty((n_experts, k, n), dtype=torch.float32, device=x.device)
    _build.check_aligned(x, dy, dw)
    with torch.cuda.device(x.device):
        err = _library().kubeflow_gmm_dw(
            x.data_ptr(), dy.data_ptr(), tiles.data_ptr(), dw.data_ptr(),
            m, k, n, n_experts, block_m, _DTYPE_CODES[x.dtype], _stream(x))
    if err:
        raise RuntimeError(f"grouped_matmul_dw kernel launch failed: CUDA "
                           f"error {err}")
    grouped_matmul_dw.launches += 1
    return dw


# ----------------------------------------------------------- autograd

class _Gmm(torch.autograd.Function):
    """K6 forward; backward dx = K6 on ``dout`` with the weights read
    transposed, dw = K7 rounded to w's dtype (``_gmm_bwd``,
    ``grouped_matmul.py:203-209``); no gradient for the layout ints."""

    @staticmethod
    def forward(ctx, x, w, block_expert, first, last, block_m):
        ctx.save_for_backward(x, w, block_expert, first, last)
        ctx.block_m = block_m
        return grouped_matmul(x, w, block_expert, block_m)

    @staticmethod
    def backward(ctx, dout):
        x, w, block_expert, first, last = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul(dout, w.transpose(1, 2), block_expert,
                                ctx.block_m)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dout, block_expert, first, last,
                                   w.shape[0], ctx.block_m).to(w.dtype)
        return dx, dw, None, None, None, None


def gmm(x, w, block_expert, first, last, block_m=256):
    """Block-diagonal grouped matmul ``out[i] = x[i] @ w[g(i)]`` with
    ``g`` constant within each ``block_m``-row tile
    (``block_expert[i // block_m]``); ``first``/``last`` mark each
    expert's first/last tile for the dw pass (int32, from
    :func:`padded_group_layout`). Differentiable in x and w (K6, K7)."""
    return _Gmm.apply(x, w, block_expert, first, last, block_m)


grouped_matmul.launches = 0
grouped_matmul_dw.launches = 0
