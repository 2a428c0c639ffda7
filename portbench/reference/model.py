"""The reference forward, loss and serving logits.

The layer is Mistral's (``MistralDecoderLayer``): pre-norm RMSNorm,
grouped-query attention with rotary position embedding, causal, and a
SwiGLU MLP ``w_down(silu(x w_gate) · x w_up)``; Mixtral's sparse MLP
routes each token to its top-k of the experts by the softmax of an fp32
router, the chosen probabilities renormalised to sum to one, every
token computed (no capacity). Departures from the published models,
each following the configuration as the port runs it and stated in its
file: the norm epsilon is ``rms_norm_eps`` of the file; rotary
embedding turns interleaved (even, odd) pairs of a head's dims (a fixed
permutation of the dims of q and k against ``rotate_half``, the same
model under random weights); the loss adds ``z_loss_coef · logsumexp²``
per token and ``router_aux_loss_coef`` times the load-balancing term
``E · Σ_e (share of tokens whose first choice is e) · (mean probability
of e)``, averaged over layers; Mistral's sliding window equals the
longest context served, so full causal attention is the windowed one.

Attention is computed in blocks of query rows (:class:`CausalAttention`,
with a backward that recomputes each block's probabilities), so a 32k
sequence never holds its whole score matrix.
"""

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Model:
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    rope_theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    aux_coef: float = 0.0
    z_coef: float = 0.0

    @classmethod
    def of(cls, config):
        heads = config["num_attention_heads"]
        return cls(d=config["hidden_size"],
                   layers=config["num_hidden_layers"], heads=heads,
                   kv_heads=config.get("num_key_value_heads") or heads,
                   head_dim=config.get("head_dim")
                   or config["hidden_size"] // heads,
                   ffn=config["intermediate_size"],
                   vocab=config["vocab_size"],
                   rope_theta=float(config["rope_theta"]),
                   eps=float(config["rms_norm_eps"]),
                   experts=config.get("num_local_experts") or 0,
                   top_k=config.get("num_experts_per_tok") or 0,
                   aux_coef=float(config.get("router_aux_loss_coef", 0.0)),
                   z_coef=float(config.get("z_loss_coef", 0.0)))


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for the enclosed block (float32 products in float32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x):
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), back in float32. The gradient passes
    the rounding unchanged (a straight-through estimator), as in
    training with float8 products."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return x + (q - x.detach())


def mm(a, b, precision):
    if precision == "fp8":
        a, b = fp8(a), fp8(b)
    return a @ b


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x ``[B, S, H, D]``: each (even, odd) pair of dims turned by
    ``position · theta^(-2i/D)``."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = positions.float()[:, None] * freqs
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], -1).reshape(
        x.shape)


def _block_scores(q, k, i0, scale):
    """Scores of query rows ``[i0, i0 + rows)`` against keys ``[0, i0 +
    rows)``, the causal mask applied."""
    rows = q.shape[-2]
    s = (q @ k[..., :i0 + rows, :].transpose(-1, -2)) * scale
    r = torch.arange(rows, device=q.device)[:, None] + i0
    c = torch.arange(i0 + rows, device=q.device)[None, :]
    return s.masked_fill(c > r, float("-inf"))


class CausalAttention(torch.autograd.Function):
    """Causal softmax attention over ``[B, H, S, D]`` (k and v already
    repeated to the query heads), by blocks of ``block`` query rows."""

    @staticmethod
    def forward(ctx, q, k, v, block):
        S, D = q.shape[-2:]
        scale = 1.0 / math.sqrt(D)
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:-1], dtype=q.dtype, device=q.device)
        for i0 in range(0, S, block):
            i1 = min(S, i0 + block)
            s = _block_scores(q[..., i0:i1, :], k, i0, scale)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            den = p.sum(-1, keepdim=True)
            out[..., i0:i1, :] = (p @ v[..., :i1, :]) / den
            lse[..., i0:i1] = (m + torch.log(den))[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        S, D = q.shape[-2:]
        scale = 1.0 / math.sqrt(D)
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        delta = (dout * out).sum(-1)
        for i0 in range(0, S, ctx.block):
            i1 = min(S, i0 + ctx.block)
            qb, dob = q[..., i0:i1, :], dout[..., i0:i1, :]
            p = torch.exp(_block_scores(qb, k, i0, scale)
                          - lse[..., i0:i1, None])
            dv[..., :i1, :] += p.transpose(-1, -2) @ dob
            ds = p * (dob @ v[..., :i1, :].transpose(-1, -2)
                      - delta[..., i0:i1, None]) * scale
            dq[..., i0:i1, :] = ds @ k[..., :i1, :]
            dk[..., :i1, :] += ds.transpose(-1, -2) @ qb
        return dq, dk, dv, None


def attention(q, k, v, block):
    """q ``[B, S, H, D]``, k/v ``[B, S, KV, D]`` → ``[B, S, H, D]``."""
    rep = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    o = CausalAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), block)
    return o.transpose(1, 2)


def moe(h, lw, m, precision):
    """h ``[T, D]`` → ``(out [T, D], aux)``: top-k routing over every
    expert, each expert's SwiGLU over the tokens routed to it, the
    outputs weighted by the renormalised gates."""
    probs = torch.softmax(h @ lw["router"], dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(m.experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = mm(F.silu(mm(x, lw["we_gate"][e], precision))
               * mm(x, lw["we_up"][e], precision), lw["we_down"][e],
               precision)
        out = out.index_add(0, tok, y * gates[tok, slot, None])
    first = F.one_hot(idx[:, 0], m.experts).float().mean(0)
    return out, m.experts * (first * probs.mean(0)).sum()


def layer(x, lw, positions, m, precision="fp32", block=512):
    """One layer on ``x [B, S, D]`` float32 → ``(x, aux or None)``;
    ``lw`` holds the layer's weights (float32, the weights' layout
    without the layer dim)."""
    B, S, D = x.shape
    h = rmsnorm(x, lw["attn_norm"], m.eps)
    q = mm(h, lw["wq"].reshape(D, -1), precision).view(B, S, m.heads, -1)
    k = mm(h, lw["wk"].reshape(D, -1), precision).view(B, S, m.kv_heads, -1)
    v = mm(h, lw["wv"].reshape(D, -1), precision).view(B, S, m.kv_heads, -1)
    q, k = rope(q, positions, m.rope_theta), rope(k, positions, m.rope_theta)
    o = attention(q, k, v, block).reshape(B, S, -1)
    x = x + mm(o, lw["wo"].reshape(-1, D), precision)
    h = rmsnorm(x, lw["mlp_norm"], m.eps)
    if m.experts:
        out, aux = moe(h.reshape(B * S, D), lw, m, precision)
        return x + out.view(B, S, D), aux
    act = F.silu(mm(h, lw["w_gate"], precision)) \
        * mm(h, lw["w_up"], precision)
    return x + mm(act, lw["w_down"], precision), None


def layer_weights(params, i, dtype=torch.float32):
    """Layer ``i``'s leaves of a stacked ``layers`` dict, in ``dtype``."""
    return {k: v[i].to(dtype) for k, v in params["layers"].items()}


def loss(params, rows, m, precision="fp32", block=512, half_batch=False):
    """The training loss of ``rows [B, S + 1]`` under float32
    ``params``: the mean over tokens of ``nll + z_coef · logz²`` plus
    ``aux_coef`` times the layers' mean aux. ``half_batch`` (a planted
    fault) takes the mean over the first half of the rows only."""
    if half_batch:
        rows = rows[: rows.shape[0] // 2]
    tokens, targets = rows[:, :-1], rows[:, 1:]
    positions = torch.arange(tokens.shape[1], device=rows.device)
    x = params["embed"][tokens]
    aux = x.new_zeros(())
    for i in range(m.layers):
        x, a = layer(x, layer_weights(params, i), positions, m, precision,
                     block)
        if a is not None:
            aux = aux + a / m.layers
    x = rmsnorm(x, params["final_norm"], m.eps)
    logits = mm(x, params["head"], precision)
    logz = torch.logsumexp(logits, -1)
    nll = logz - logits.gather(-1, targets[..., None])[..., 0]
    return (nll + m.z_coef * logz.square()).mean() + m.aux_coef * aux


@torch.no_grad()
def served_logits(params, seqs, positions, m, precisions=("fp32",),
                  block=1024):
    """The logits at ``positions[j]`` of each token sequence
    ``seqs[j]`` → ``{precision: [float32 [len(positions[j]), V]]}``.
    ``params`` may be in any dtype: each layer is widened to float32
    when it is used, one at a time, and every sequence passes through it
    before the next (so the whole model is never held in float32)."""
    xs = {p: [params["embed"][s].float()[None] for s in seqs]
          for p in precisions}
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for i in range(m.layers):
        lw = layer_weights(params, i)
        for p in precisions:
            xs[p] = [layer(x, lw, ps, m, p, block)[0]
                     for x, ps in zip(xs[p], pos)]
        del lw
    head = params["head"].float()
    norm = params["final_norm"].float()
    return {p: [mm(rmsnorm(x[0, at], norm, m.eps), head, p)
                for x, at in zip(xs[p], positions)] for p in precisions}
