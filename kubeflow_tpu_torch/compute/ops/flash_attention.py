"""K3, K4 and K5 — the tiled attention forward and its backward, as
hand-written CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``)
beside their plain PyTorch versions.

Replace the Pallas TPU kernels of
``kubeflow_tpu/compute/ops/flash_attention.py``: ``_fwd_kernel`` (:36,
K3), ``_bwd_dq_kernel`` (:83, K4) and ``_bwd_dkv_kernel`` (:127, K5),
which JAX joins with a ``custom_vjp`` and this module with a
``torch.autograd.Function``.

:func:`flash_attention` returns ``(out, lse)``; gradients reach q, k
and v through :func:`flash_attention_bwd` (lse is not differentiable).
Every wrapper launches its kernel for CUDA tensors and takes the plain
version (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`) only for CPU tensors; on a CUDA
tensor it launches or raises, never falls back. Each kernel counts its
launches on its wrapper: ``flash_attention.launches`` (K3),
``flash_attention_bwd_dq.launches`` (K4) and
``flash_attention_bwd_dkv.launches`` (K5).
"""

import ctypes

import torch

from ..attention import NEG_INF, repeat_kv
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_libs = {}


def _resolve_scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def _prescale(q, scale):
    """Softmax scale folded into q in fp32 and rounded ONCE to q's dtype
    (``flash_attention.py:46``, and again in both backward kernels)."""
    return (q.float() * _resolve_scale(q, scale)).to(q.dtype)


def _causal_mask(q, k):
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    return q_pos[:, None] >= k_pos[None, :]


def flash_attention_reference(q, k, v, causal=True, scale=None):
    """Plain version of K3, on any device. q ``[B, S, H, D]``; k, v
    ``[B, Sk, kv_heads, D]`` with ``kv_heads`` dividing ``H`` →
    ``(out [B, S, H, D] in q's dtype, lse [B, H, S] fp32)``.

    Numerics of the TPU kernel in one pass: fp32 scores from
    input-dtype operands, fp32 softmax statistics, ``p`` rounded to the
    input dtype for the value product while ``l`` sums the unrounded
    ``p``."""
    dt = q.dtype
    n_rep = q.shape[2] // k.shape[2]
    qs = _prescale(q, scale)
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        s = torch.where(_causal_mask(q, k), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), v.float())
    out = (o / l.permute(0, 2, 1, 3)).to(dt)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def attention_delta(out, do):
    """``delta = rowsum(dO ⊙ O)`` in fp32 from the rounded ``out`` →
    ``[B, H, S]``: one elementwise pass and a reduction, plain PyTorch
    here as it is XLA in JAX (``flash_attention.py:222-225``)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_reference(q, k, v, do, lse, delta, causal, scale):
    dt = q.dtype
    B, S, H, D = q.shape
    kv = k.shape[2]
    n_rep = H // kv
    scale = _resolve_scale(q, scale)
    qs = _prescale(q, scale)
    kr = repeat_kv(k, n_rep).float()
    vr = repeat_kv(v, n_rep).float()
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kr)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(q, k), p, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    # the n_rep query heads of one kv head sum in fp32, one rounding
    Sk = k.shape[1]
    dk = dk.reshape(B, Sk, kv, n_rep, D).sum(3) * scale
    dv = dv.reshape(B, Sk, kv, n_rep, D).sum(3)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True,
                                  scale=None):
    """Plain version of K4 and K5 together, on any device: the gradients
    ``(dq, dk, dv)`` of :func:`flash_attention_reference`'s ``out`` for
    the output gradient ``do``, shapes as its inputs.

    The TPU kernels' numerics in one pass (``_dense_bwd``'s structure,
    ``flash_attention.py:331-348``, with the kernels' roundings): p
    recomputed from the same pre-scaled q against the forward's lse,
    ``dp = dO·Vᵀ`` and every product from input-dtype operands with fp32
    sums, ``dv = p.astype(dt)ᵀ·dO``, ``ds = (p·(dp − delta)).astype(dt)``
    rounded once for both dq and dk, ``dq = scale·ds·K``, ``dk =
    scale·dsᵀ·q`` with the RAW q. For GQA the per-head dK/dV of one kv
    head sum in fp32 before one rounding, as K5 does."""
    return _bwd_reference(q, k, v, do, lse, attention_delta(out, do),
                          causal, scale)


def _library(name):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    lib = _build.load(name)
    if name == "flash_fwd":
        fn = lib.kubeflow_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    else:
        for fn, n_out in ((lib.kubeflow_flash_bwd_dq, 1),
                          (lib.kubeflow_flash_bwd_dkv, 2)):
            fn.argtypes = ([ctypes.c_void_p] * (6 + n_out)
                           + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def _check(q, k, v, causal, *more):
    """Raise on what the kernels do not take; ``more`` are tensors that
    must share q's device, dtype and shape (dO)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, S, H, D] with k and v of "
                         f"one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Sk, kv_heads = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % kv_heads:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (kv heads must divide heads)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"dtypes must be one of float32/bfloat16 and "
                        f"equal, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if causal and S != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {S} "
                         f"and {Sk}")
    if Sk < 1:
        raise ValueError("empty key sequence")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k, v must be on one device")
    for t in more:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"the output gradient must match q: "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_stats(q, *stats):
    B, S, H, _ = q.shape
    for t in stats:
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"lse/delta must be fp32 [B, H, S] = "
                             f"{(B, H, S)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _forward(q, k, v, causal, scale):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _check(q, k, v, causal)
    B, S, H, D = q.shape
    Sk, kv_heads = k.shape[1], k.shape[2]
    qs = _prescale(q, scale).contiguous()
    k = k.contiguous()
    v = v.contiguous()
    _build.check_aligned(qs, k, v)
    out = torch.empty_like(qs)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    # the launch goes to the runtime's current device: make it q's
    with torch.cuda.device(q.device):
        err = _library("flash_fwd").kubeflow_flash_fwd(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, Sk, H, kv_heads, D, int(bool(causal)),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out, lse


def _bwd_operands(q, k, v, do, lse, delta, causal):
    _check(q, k, v, causal, do)
    _check_stats(q, lse, delta)
    ops = [t.contiguous() for t in (q, k, v, do, lse, delta)]
    _build.check_aligned(*ops)
    return ops


def _launch_bwd(symbol, ops, outs, q, k, causal, scale):
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        err = getattr(_library("flash_bwd"), symbol)(
            *(t.data_ptr() for t in ops), *(t.data_ptr() for t in outs),
            B, S, k.shape[1], H, k.shape[2], D, int(bool(causal)),
            _DTYPE_CODES[q.dtype], float(_resolve_scale(q, scale)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True,
                           scale=None):
    """K4: ``dq`` of the attention whose forward gave ``lse``, from raw
    q ``[B, S, H, D]``, k/v ``[B, Sk, kv_heads, D]``, the output gradient
    ``do`` (as q) and ``delta`` (:func:`attention_delta`), both stats
    fp32 ``[B, H, S]``. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, do, lse, delta, causal, scale)[0]
    ops = _bwd_operands(q, k, v, do, lse, delta, causal)
    dq = torch.empty_like(ops[0])
    if q.shape[0] and q.shape[1]:
        _launch_bwd("kubeflow_flash_bwd_dq", ops, (dq,), q, k, causal,
                    scale)
        flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True,
                            scale=None):
    """K5: ``(dk, dv)`` in k's layout, summed over the query heads of
    each kv head; arguments as :func:`flash_attention_bwd_dq`."""
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, do, lse, delta, causal, scale)[1:]
    ops = _bwd_operands(q, k, v, do, lse, delta, causal)
    if not (q.shape[0] and q.shape[1]):     # no query: zero gradients
        return torch.zeros_like(ops[1]), torch.zeros_like(ops[2])
    dk = torch.empty_like(ops[1])
    dv = torch.empty_like(ops[2])
    _launch_bwd("kubeflow_flash_bwd_dkv", ops, (dk, dv), q, k, causal,
                scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal=True, scale=None):
    """``(dq, dk, dv)`` for the output gradient ``do``: on the card
    ``delta`` (plain PyTorch) then K4 and K5; on the CPU the plain
    version in one pass."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             causal, scale)
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                     scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K3 forward, K4 + K5 backward: the ``custom_vjp`` of
    ``flash_attention.py:274-361``. Saves q (raw), k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None):
    """Tiled attention → ``(out, lse)``; shapes as
    :func:`flash_attention_reference`. Causal needs ``Sq == Sk``.
    Differentiable in q, k and v where autograd records (K4/K5)."""
    return _FlashAttention.apply(q, k, v, causal, scale)


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
