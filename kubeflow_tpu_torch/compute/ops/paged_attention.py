"""The reads over the paged KV pool, as hand-written CUDA kernels beside
their plain PyTorch versions:

- K1, the one-token decode read (``csrc/paged_decode.cu``), replaces the
  Pallas TPU kernel ``_decode_kernel``
  (``kubeflow_tpu/compute/ops/paged_attention.py:49``, through
  ``paged_decode_attention``);
- K2, the multi-token chunk-after-prefix read (``csrc/paged_chunk.cu``),
  replaces ``_chunk_kernel`` (same file, :190, through
  ``paged_chunk_attention``) — the read of the cached partial prefill,
  of every prefill chunk and of the speculative verify.

Float pages only; the int8-page variants come with the int8 pool.
Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors; on a CUDA tensor it launches or raises,
never falls back.
"""

import ctypes

import torch

from .. import attention as attn_lib
from . import _build
from .flash_attention import _prescale

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
MAX_REP = 16
_libs = {}


def paged_decode_reference(q, pages, tables, lengths, *, block_size,
                           n_rep=1, scale=None):
    """Plain version of the kernel, on any device: q ``[S, 1, H, D]``,
    ``pages`` one layer's ``(k, v)`` pool slice ``[N, bs, kv, D]``,
    ``tables`` ``[S, bps]``, ``lengths`` ``[S]`` → ``[S, 1, H, D]``.
    The kernel's numerics: the scale folded into q in fp32 and rounded
    once, then the masked fp32 online softmax over the table's blocks
    (``attention.paged_decode_attention``'s fold, whose per-page math is
    the TPU kernel's)."""
    return attn_lib.paged_decode_attention(
        _prescale(q, scale), pages, tables, lengths,
        block_size=block_size, n_rep=n_rep, scale=1.0)


# per source: (C entry point, pointer args, int args)
_SIGNATURES = {"paged_decode": ("kubeflow_paged_decode", 6, 7),
               "paged_chunk": ("kubeflow_paged_chunk", 8, 8)}


def _entry(name):
    """The bound C entry point of ``csrc/<name>.cu``, built if stale."""
    fn = _libs.get(name)
    if fn is None:
        symbol, n_ptr, n_int = _SIGNATURES[name]
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return fn


def _check_pool(q, pages, block_size, n_rep):
    """Shared checks of the pool reads → ``(kc, vc, kv_heads)``."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if len(pages) != 2:
        raise NotImplementedError(
            "int8 pages are not ported yet (float (k, v) pages only)")
    kc, vc = pages
    H, D = q.shape[-2:]
    if kc.dim() != 4 or kc.shape != vc.shape:
        raise ValueError(f"pages must be two [N, bs, kv, D] tensors, got "
                         f"{tuple(kc.shape)} and {tuple(vc.shape)}")
    N, bs, kv_heads, Dk = kc.shape
    if bs != int(block_size) or Dk != D or kv_heads * n_rep != H:
        raise ValueError(
            f"pool {tuple(kc.shape)} does not match q {tuple(q.shape)} "
            f"with block_size={block_size}, n_rep={n_rep}")
    if not 1 <= n_rep <= MAX_REP:
        raise ValueError(f"n_rep {n_rep} outside [1, {MAX_REP}]")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or kc.dtype != q.dtype \
            or vc.dtype != q.dtype:
        raise TypeError(f"dtypes must be one of float32/bfloat16 and "
                        f"equal, got {q.dtype}, {kc.dtype}, {vc.dtype}")
    if not (kc.device == vc.device == q.device):
        raise ValueError("q and the pool pages must be on one device")
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("pool pages must be contiguous")
    return kc, vc, kv_heads


def paged_decode_attention(q, pages, tables, lengths, *, block_size,
                           n_rep=1, scale=None):
    """Decode read over the paged pool; shapes as
    :func:`paged_decode_reference`. Launches on the caller's current
    CUDA stream and does not synchronise. The table entries a slot's
    length reaches (the first ``ceil(length / block_size)``) must be
    block ids below ``N``: checking them on the host would cost a
    device sync per call, and the engine builds its tables from its own
    allocator."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, pages, tables, lengths,
                                      block_size=block_size, n_rep=n_rep,
                                      scale=scale)
    kc, vc, kv_heads = _check_pool(q, pages, block_size, n_rep)
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
    _build.check_aligned(qs, kc, vc)
    out = torch.empty_like(qs)
    # the launch goes to the runtime's current device: make it q's
    with torch.cuda.device(q.device):
        err = _entry("paged_decode")(
            qs.data_ptr(), kc.data_ptr(), vc.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), S, kv_heads, n_rep, D,
            kc.shape[1], tables.shape[1], _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA "
                           f"error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_chunk_reference(q, pages, tables, prefix_len, k_chunk, v_chunk,
                          *, block_size, n_rep=1, scale=None):
    """Plain version of K2, on any device: q ``[B, S, H, D]``, ``pages``
    one layer's ``(k, v)`` pool slice ``[N, bs, kv, D]``, ``tables``
    ``[B, bps]``, ``prefix_len`` an int or ``[B]``, ``k_chunk``/
    ``v_chunk`` ``[B, S, kv, D]`` → ``[B, S, H, D]``. The kernel's
    numerics: the scale folded into q in fp32 and rounded once
    (``paged_attention.py:284``), then ``attention.paged_chunk_attention``
    (masked fp32 online softmax, p kept in fp32 for p·V, the
    ``l == 0 → 1`` guard)."""
    return attn_lib.paged_chunk_attention(
        _prescale(q, scale), pages, tables, prefix_len, k_chunk, v_chunk,
        block_size=block_size, n_rep=n_rep, scale=1.0)


def paged_chunk_attention(q, pages, tables, prefix_len, k_chunk, v_chunk,
                          *, block_size, n_rep=1, scale=None):
    """Chunk-after-prefix read over the paged pool; shapes as
    :func:`paged_chunk_reference`. A scalar ``prefix_len`` is broadcast
    to ``[B]`` (``paged_attention.py:288``). Launches on the caller's
    current CUDA stream and does not synchronise; as for the decode
    read, the first ``ceil(prefix_len[b] / block_size)`` table entries
    of every row must be block ids below ``N``."""
    if q.device.type == "cpu":
        return paged_chunk_reference(q, pages, tables, prefix_len, k_chunk,
                                     v_chunk, block_size=block_size,
                                     n_rep=n_rep, scale=scale)
    kc, vc, kv_heads = _check_pool(q, pages, block_size, n_rep)
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
    _build.check_aligned(qs, kc, vc, k_chunk, v_chunk)
    out = torch.empty_like(qs)
    with torch.cuda.device(q.device):
        err = _entry("paged_chunk")(
            qs.data_ptr(), kc.data_ptr(), vc.data_ptr(), tables.data_ptr(),
            plens.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            out.data_ptr(), B, S, kv_heads, n_rep, D, kc.shape[1],
            tables.shape[1], _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_chunk kernel launch failed: CUDA error "
                           f"{err}")
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0
