"""Chunked softmax cross-entropy — the LM loss without the fp32
``[B, S, V]`` logits.

Port of ``kubeflow_tpu/compute/ops/cross_entropy.py`` (:75-139): a
``lax.scan`` over vocab chunks under a ``custom_vjp`` there, a Python
loop inside a ``torch.autograd.Function`` here. The forward keeps a
running (max, sum of exp, label logit, argmax) per token in fp32; the
backward recomputes each chunk's logits to form ``dx`` and ``dhead``,
trading a second chunk product for O(tokens) residuals. Plain PyTorch:
the JAX op is XLA, not a Pallas kernel.

Numerics as JAX: chunk logits are fp32 sums of products of the operands
in their own dtype (both widened exactly; TF32 off on the card),
reductions in fp32, ``dx``/``dhead`` summed in fp32 and cast once.
"""

import torch

NEG_INF = -1e30


def _chunks(head, chunk):
    v = head.shape[1]
    if v % chunk:
        raise ValueError(
            f"ce_chunk={chunk} must divide vocab_size={v} "
            f"(pick a divisor, e.g. {v // (v // chunk or 1)})")
    return range(0, v, chunk)


def _fwd(xf, head, targets, chunk):
    """→ (logz [N], label logit [N], argmax [N]) over flat tokens."""
    n = xf.shape[0]
    dev = xf.device
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((n,), dtype=torch.float32, device=dev)
    label = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
    best = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.long, device=dev)
    x32 = xf.float()
    for base in _chunks(head, chunk):
        s = x32 @ head[:, base:base + chunk].float()        # [N, chunk]
        s_max, s_arg = s.max(dim=1)
        m_new = torch.maximum(m, s_max)
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(1)
        m = m_new
        local = targets - base
        in_chunk = (local >= 0) & (local < chunk)
        picked = torch.gather(s, 1, local.clamp(0, chunk - 1)[:, None])[:, 0]
        label = torch.where(in_chunk, picked, label)
        # running argmax: an earlier chunk keeps a tie, as in JAX
        better = s_max > best
        best_idx = torch.where(better, base + s_arg, best_idx)
        best = torch.maximum(best, s_max)
    return m + torch.log(l), label, best_idx


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, targets, chunk):
        shape = targets.shape
        xf = x.reshape(-1, x.shape[-1])
        tf = targets.reshape(-1).long()
        logz, label, pred = _fwd(xf, head, tf, chunk)
        ctx.save_for_backward(x, head, tf, logz)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(pred)
        return ((logz - label).reshape(shape), logz.reshape(shape),
                pred.reshape(shape))

    @staticmethod
    def backward(ctx, g_nll, g_logz, _g_pred):
        x, head, tf, logz = ctx.saved_tensors
        chunk = ctx.chunk
        xf = x.reshape(-1, x.shape[-1]).float()
        gn = g_nll.reshape(-1).float()
        gtot = gn + g_logz.reshape(-1).float()    # d/ds of the logz term
        dx = torch.zeros_like(xf)
        dhead = torch.empty(head.shape, dtype=torch.float32,
                            device=head.device)
        rows = torch.arange(xf.shape[0], device=xf.device)
        for base in _chunks(head, chunk):
            hc = head[:, base:base + chunk].float()
            s = xf @ hc
            ds = torch.exp(s - logz[:, None]) * gtot[:, None]   # softmax
            local = tf - base
            in_chunk = (local >= 0) & (local < chunk)
            # the one-hot term, zero outside the chunk
            ds[rows[in_chunk], local[in_chunk]] -= gn[in_chunk]
            dx += ds @ hc.T
            dhead[:, base:base + chunk] = xf.T @ ds
        return (dx.reshape(x.shape).to(x.dtype), dhead.to(head.dtype),
                None, None)


def chunked_softmax_xent(x, head, targets, chunk=2048):
    """x ``[..., D]``, head ``[D, V]``, targets ``[...]`` int →
    ``(nll, logz, pred)`` per token (fp32, fp32, int64 argmax for the
    accuracy metric); callers build loss and z-loss from these exactly
    as with dense logits. ``chunk`` must divide V."""
    return _ChunkedXent.apply(x, head, targets, chunk)
