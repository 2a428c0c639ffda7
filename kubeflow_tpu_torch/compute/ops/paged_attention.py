"""The reads over the paged KV pool, as hand-written CUDA kernels beside
their plain PyTorch versions:

- K1, the one-token decode read (``csrc/paged_decode.cu``), replaces the
  Pallas TPU kernel ``_decode_kernel``
  (``kubeflow_tpu/compute/ops/paged_attention.py:49``, through
  ``paged_decode_attention``). Its key walk is split over blocks
  (:func:`decode_splits`), the splits' partials merged in split order by
  a second kernel of the same C call, in both dtypes; one wrapper call
  counts one launch;
- K2, the multi-token chunk-after-prefix read (``csrc/paged_chunk.cu``),
  replaces ``_chunk_kernel`` (same file, :190, through
  ``paged_chunk_attention``) — the read of the cached partial prefill,
  of every prefill chunk and of the speculative verify. In bf16 its
  products run on the tensor cores and its key walk is split over
  blocks (:func:`chunk_splits`), the splits' partials merged in split
  order by a second kernel of the same C call; one wrapper call counts
  one launch.

Both take one layer's pool as a float ``(k, v)`` pair in q's dtype or as
the int8 quadruple ``(k, v, k_scale, v_scale)`` of the engine's
``kv_dtype="int8"`` pool (int8 pages, fp32 scales ``[N, bs, kv, 1]``).
An int8 pool goes to its own entry point of the same source (K1-i8,
K2-i8: the ``int8_pages`` branches of the TPU kernels, :75-81 and
:236-240), which dequantizes each page in registers with the TPU
kernels' rounding: the int8 code times the fp32 scale in fp32, rounded
once to q's dtype. K2-i8 dequantizes the prefix pages only; the chunk's
own K/V stay in q's dtype. Launches are counted per entry point:
``paged_decode_attention.launches`` / ``.launches_i8`` and
``paged_chunk_attention.launches`` / ``.launches_i8``.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors; on a CUDA tensor it launches or raises,
never falls back.
"""

import ctypes
import functools

import torch

from .. import attention as attn_lib
from . import _build
from .flash_attention import _prescale

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
MAX_REP = 16
_libs = {}


def _dequant_kernel(pages, dtype):
    """One block of the pool as the kernels widen it: a float pair as it
    is; int8 pages as ``(int8 → fp32) × fp32 scale``, rounded once to
    ``dtype`` (``paged_attention.py:80-81``). In bf16 this differs from
    ``quantize.kv_dequantize`` (scale rounded to bf16, product in bf16)
    by up to one unit in the last place; in fp32 the two are equal."""
    if len(pages) == 2:
        return pages
    k, v, ks, vs = pages
    return (k.float() * ks).to(dtype), (v.float() * vs).to(dtype)


def paged_decode_reference(q, pages, tables, lengths, *, block_size,
                           n_rep=1, scale=None):
    """Plain version of the kernel, on any device: q ``[S, 1, H, D]``,
    ``pages`` one layer's ``(k, v)`` pool slice ``[N, bs, kv, D]`` or its
    int8 quadruple, ``tables`` ``[S, bps]``, ``lengths`` ``[S]`` →
    ``[S, 1, H, D]``. The kernel's numerics: the scale folded into q in
    fp32 and rounded once, int8 pages widened as :func:`_dequant_kernel`
    does, then the masked fp32 online softmax over the table's blocks
    (``attention.paged_decode_attention``'s fold, whose per-page math is
    the TPU kernel's)."""
    return attn_lib.paged_decode_attention(
        _prescale(q, scale), pages, tables, lengths,
        block_size=block_size, n_rep=n_rep, scale=1.0,
        dequant=_dequant_kernel)


# per entry point: (source, C symbol, pointer args, int args)
_SIGNATURES = {
    "paged_decode": ("paged_decode", "kubeflow_paged_decode", 7, 8),
    "paged_decode_i8": ("paged_decode", "kubeflow_paged_decode_i8", 9, 8),
    "paged_chunk": ("paged_chunk", "kubeflow_paged_chunk", 9, 9),
    "paged_chunk_i8": ("paged_chunk", "kubeflow_paged_chunk_i8", 11, 9)}
#: K2's query-row tile and key tile (``csrc/paged_chunk.cu``)
CHUNK_ROW_TILE = 64
CHUNK_KEY_TILE = 64
#: K1's tile of positions (``csrc/paged_decode.cu``)
DECODE_TILE = 32


def _entry(name):
    """The bound C entry point ``name``, its source built if stale."""
    fn = _libs.get(name)
    if fn is None:
        source, symbol, n_ptr, n_int = _SIGNATURES[name]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return fn


def _check_int8_pages(kc, vc, ks, vs):
    if kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise TypeError(f"int8 pages: k and v must be int8, got "
                        f"{kc.dtype} and {vc.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"int8 pages: the scales must be float32, got "
                        f"{ks.dtype} and {vs.dtype}")
    want = tuple(kc.shape[:3]) + (1,)
    if tuple(ks.shape) != want or tuple(vs.shape) != want:
        raise ValueError(f"int8 pages: the scales must be {want}, got "
                         f"{tuple(ks.shape)} and {tuple(vs.shape)}")


def _check_pool(q, pages, block_size, n_rep):
    """Shared checks of the pool reads → ``(pages, kv_heads)``: a float
    ``(k, v)`` pair in q's dtype or an int8 ``(k, v, k_scale, v_scale)``
    quadruple, all contiguous on q's device."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if len(pages) not in (2, 4):
        raise ValueError(f"pages must be a (k, v) pair or a (k, v, "
                         f"k_scale, v_scale) quadruple, got {len(pages)} "
                         f"tensors")
    kc, vc = pages[:2]
    H, D = q.shape[-2:]
    if kc.dim() != 4 or kc.shape != vc.shape:
        raise ValueError(f"pages must be two [N, bs, kv, D] tensors, got "
                         f"{tuple(kc.shape)} and {tuple(vc.shape)}")
    if len(pages) == 4:
        _check_int8_pages(*pages)
    elif kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise TypeError(f"float pages must be q's dtype {q.dtype}, got "
                        f"{kc.dtype} and {vc.dtype}")
    N, bs, kv_heads, Dk = kc.shape
    if bs != int(block_size) or Dk != D or kv_heads * n_rep != H:
        raise ValueError(
            f"pool {tuple(kc.shape)} does not match q {tuple(q.shape)} "
            f"with block_size={block_size}, n_rep={n_rep}")
    if not 1 <= n_rep <= MAX_REP:
        raise ValueError(f"n_rep {n_rep} outside [1, {MAX_REP}]")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if not all(p.device == q.device for p in pages):
        raise ValueError("q and the pool pages must be on one device")
    if not all(p.is_contiguous() for p in pages):
        raise ValueError("pool pages must be contiguous")
    return tuple(pages), kv_heads


def paged_decode_attention(q, pages, tables, lengths, *, block_size,
                           n_rep=1, scale=None, split_heads=None):
    """Decode read over the paged pool; shapes as
    :func:`paged_decode_reference`. Launches on the caller's current
    CUDA stream and does not synchronise. The table entries a slot's
    length reaches (the first ``ceil(length / block_size)``) must be
    block ids below ``N``: checking them on the host would cost a
    device sync per call, and the engine builds its tables from its own
    allocator. ``split_heads`` is the KV-head count the split rule
    (:func:`decode_splits`) is evaluated at, default the pool's own: a
    head-partitioned shard of the engine passes the model's whole count,
    so each head's walk splits — and its partials merge — as in the
    unsharded engine, and its output is that engine's bit for bit."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, pages, tables, lengths,
                                      block_size=block_size, n_rep=n_rep,
                                      scale=scale)
    pages, kv_heads = _check_pool(q, pages, block_size, n_rep)
    S, one, H, D = q.shape
    if one != 1:
        raise ValueError(f"q must be [S, 1, H, D], got {tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != S \
            or lengths.shape != (S,):
        raise ValueError(f"tables must be [S, bps] and lengths [S] for "
                         f"S={S}, got {tuple(tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    if not (tables.device == lengths.device == q.device):
        raise ValueError("q, pages, tables and lengths must be on one "
                         "device")
    qs = _prescale(q, scale).contiguous()
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    # 16-byte words move q and the pages; the scales are read as scalars
    _build.check_aligned(qs, *pages[:2])
    out = torch.empty_like(qs)
    bs, bps = pages[0].shape[1], tables.shape[1]
    # the split key walk; the splits' fp32 partials need no zeroing
    splits = decode_splits(S, split_heads or kv_heads, bs, bps,
                           _sm_count(q.device.index))
    ws = None if splits == 1 else torch.empty(
        splits * S * H * (D + 2), dtype=torch.float32, device=q.device)
    name = "paged_decode_i8" if len(pages) == 4 else "paged_decode"
    ptrs = [t.data_ptr() for t in (qs, *pages, tables, lengths, out)]
    # the launch goes to the runtime's current device: make it q's
    with torch.cuda.device(q.device):
        err = _entry(name)(
            *ptrs, None if ws is None else ws.data_ptr(), S, kv_heads,
            n_rep, D, bs, bps, splits, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if len(pages) == 4:
        paged_decode_attention.launches_i8 += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_i8 = 0


def decode_splits(slots, kv_heads, block_size, bps, sms):
    """How many blocks share one (slot, kv head)'s key walk in K1: the
    ``slots · kv_heads`` blocks of one split times the splits cover the
    card's ``sms`` SMs about twice, never with more splits than the
    table's tiles of :data:`DECODE_TILE` positions (``bps·block_size``
    positions). One split where the grid already fills the card. Known
    from the shapes alone, so the wrapper needs no device sync."""
    blocks = slots * kv_heads
    if blocks == 0:
        return 1
    tiles = -(-(bps * block_size) // DECODE_TILE)
    return max(1, min(tiles, -(-2 * sms // blocks)))


def chunk_splits(batch, seq, kv_heads, n_rep, block_size, bps, sms):
    """How many blocks share one row tile's key walk in the bf16 K2: the
    blocks of one split (row tiles x kv heads x slots) times the splits
    cover the card's ``sms`` SMs about twice, never with more splits
    than there are key tiles in the longest walk a table allows
    (``bps·block_size`` prefix positions and ``seq`` chunk columns). One
    split where the grid already fills the card."""
    blocks = -(-seq // (CHUNK_ROW_TILE // n_rep)) * kv_heads * batch
    if blocks == 0:
        return 1
    tiles = -(-(bps * block_size + seq) // CHUNK_KEY_TILE)
    return max(1, min(tiles, -(-2 * sms // blocks)))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_chunk_reference(q, pages, tables, prefix_len, k_chunk, v_chunk,
                          *, block_size, n_rep=1, scale=None):
    """Plain version of K2, on any device: q ``[B, S, H, D]``, ``pages``
    one layer's ``(k, v)`` pool slice ``[N, bs, kv, D]`` or its int8
    quadruple, ``tables`` ``[B, bps]``, ``prefix_len`` an int or
    ``[B]``, ``k_chunk``/``v_chunk`` ``[B, S, kv, D]`` in q's dtype →
    ``[B, S, H, D]``. The kernel's numerics: the scale folded into q in
    fp32 and rounded once (``paged_attention.py:284``), int8 prefix
    pages widened as :func:`_dequant_kernel` does, then
    ``attention.paged_chunk_attention`` (masked fp32 online softmax, p
    kept in fp32 for p·V, the ``l == 0 → 1`` guard)."""
    return attn_lib.paged_chunk_attention(
        _prescale(q, scale), pages, tables, prefix_len, k_chunk, v_chunk,
        block_size=block_size, n_rep=n_rep, scale=1.0,
        dequant=_dequant_kernel)


def paged_chunk_attention(q, pages, tables, prefix_len, k_chunk, v_chunk,
                          *, block_size, n_rep=1, scale=None,
                          split_heads=None):
    """Chunk-after-prefix read over the paged pool; shapes as
    :func:`paged_chunk_reference`. A scalar ``prefix_len`` is broadcast
    to ``[B]`` (``paged_attention.py:288``). Launches on the caller's
    current CUDA stream and does not synchronise; as for the decode
    read, the first ``ceil(prefix_len[b] / block_size)`` table entries
    of every row must be block ids below ``N``. ``split_heads``: as for
    :func:`paged_decode_attention`, the KV-head count
    :func:`chunk_splits` is evaluated at."""
    if q.device.type == "cpu":
        return paged_chunk_reference(q, pages, tables, prefix_len, k_chunk,
                                     v_chunk, block_size=block_size,
                                     n_rep=n_rep, scale=scale)
    pages, kv_heads = _check_pool(q, pages, block_size, n_rep)
    B, S, H, D = q.shape
    if k_chunk.shape != (B, S, kv_heads, D) \
            or v_chunk.shape != k_chunk.shape:
        raise ValueError(f"k_chunk/v_chunk must be {(B, S, kv_heads, D)}, "
                         f"got {tuple(k_chunk.shape)} and "
                         f"{tuple(v_chunk.shape)}")
    if k_chunk.dtype != q.dtype or v_chunk.dtype != q.dtype:
        raise TypeError(f"chunk K/V must be {q.dtype}, got "
                        f"{k_chunk.dtype} and {v_chunk.dtype}")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [B, bps] for B={B}, got "
                         f"{tuple(tables.shape)}")
    if isinstance(prefix_len, torch.Tensor):
        plens = prefix_len.to(q.device, torch.int32).expand(B)
    else:
        plens = torch.full((B,), int(prefix_len), dtype=torch.int32,
                           device=q.device)
    if not all(t.device == q.device for t in (k_chunk, v_chunk, tables)):
        raise ValueError("q, pages, tables and the chunk K/V must be on "
                         "one device")
    qs = _prescale(q, scale).contiguous()
    k_chunk = k_chunk.contiguous()
    v_chunk = v_chunk.contiguous()
    tables = tables.to(torch.int32).contiguous()
    plens = plens.contiguous()
    _build.check_aligned(qs, *pages[:2], k_chunk, v_chunk)
    out = torch.empty_like(qs)
    bs, bps = pages[0].shape[1], tables.shape[1]
    # bf16 splits the key walk; the splits' fp32 partials need no zeroing
    splits = 1 if q.dtype == torch.float32 else chunk_splits(
        B, S, split_heads or kv_heads, n_rep, bs, bps,
        _sm_count(q.device.index))
    ws = None if splits == 1 else torch.empty(
        splits * B * S * H * (D + 2), dtype=torch.float32, device=q.device)
    name = "paged_chunk_i8" if len(pages) == 4 else "paged_chunk"
    ptrs = [t.data_ptr() for t in (qs, *pages, tables, plens, k_chunk,
                                   v_chunk, out)]
    with torch.cuda.device(q.device):
        err = _entry(name)(
            *ptrs, None if ws is None else ws.data_ptr(), B, S, kv_heads,
            n_rep, D, bs, bps, splits, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if len(pages) == 4:
        paged_chunk_attention.launches_i8 += 1
    else:
        paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0
paged_chunk_attention.launches_i8 = 0
