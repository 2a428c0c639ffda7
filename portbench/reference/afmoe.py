"""The reference forward of an AFMoE model (Arcee's Trinity, ``model_type``
``afmoe``) over served sequences, in plain float32 PyTorch.

The layer, as Arcee's ``modeling_afmoe.py`` writes it: ``h =
input_norm(x)``; q, k, v; an RMSNorm on each q and k head; RoPE on the
sliding layers only (the full-attention layers take no positional
encoding); causal attention, on a sliding layer over the last
``sliding_window`` keys of each query; the output times ``σ(h W_gate)``,
then ``o_proj``; ``x + post_attn_norm(·)``; then ``x +
post_mlp_norm(mlp(pre_mlp_norm(x)))``, the MLP a SwiGLU in the leading
dense layers and elsewhere the routed experts plus the shared one: each
token's top-k experts chosen by ``σ(x W_router) + expert_bias`` and
weighted by ``σ(x W_router)`` alone, divided by their sum and times
``route_scale``. The embedding is times ``√hidden_size`` (``mup``).
Departures, each following the configuration as the port runs it and
stated in its file: rotary embedding turns interleaved (even, odd)
pairs of a head's dims (a fixed permutation of the dims of q and k
against ``rotate_half``, the same model under random weights).

Attention runs in blocks of query rows against the keys they can see,
so a long sequence never holds its whole score matrix; the experts run
one at a time over the rows routed to them. The weights' layout is
``inputs/afmoe_weights.py``'s; ``precision="fp8"`` rounds both operands
of every linear product (the router's aside) to float8, as
``model.mm`` does.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F

from .model import mm, rmsnorm, rope


@dataclasses.dataclass(frozen=True)
class Model:
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int
    top_k: int
    dense_layers: int
    window: int
    global_every: int
    rope_theta: float
    eps: float
    route_scale: float

    @classmethod
    def of(cls, config):
        return cls(d=config["hidden_size"],
                   layers=config["num_hidden_layers"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config["head_dim"],
                   experts=config["num_experts"],
                   top_k=config["num_experts_per_tok"],
                   dense_layers=config["num_dense_layers"],
                   window=config["sliding_window"],
                   global_every=config["global_attn_every_n_layers"],
                   rope_theta=float(config["rope_theta"]),
                   eps=float(config["rms_norm_eps"]),
                   route_scale=float(config["route_scale"]))

    def sliding(self, i):
        """Whether layer ``i`` is a sliding one (``layer_types``)."""
        return (i + 1) % self.global_every != 0


def attention(q, k, v, window, block):
    """One sequence: q ``[S, H, D]``, k/v ``[S, KV, D]`` → ``[S, H, D]``;
    causal, each query over its last ``window`` keys (0: all)."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    k, v = (t.repeat_interleave(rep, dim=1).transpose(0, 1) for t in (k, v))
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        j0 = max(0, i0 - window + 1) if window else 0
        s = (q[:, i0:i1] @ k[:, j0:i1].transpose(-1, -2)) / math.sqrt(D)
        r = torch.arange(i0, i1, device=q.device)[:, None]
        c = torch.arange(j0, i1, device=q.device)[None, :]
        bad = c > r
        if window:
            bad = bad | (c <= r - window)
        p = torch.softmax(s.masked_fill(bad, float("-inf")), dim=-1)
        out[:, i0:i1] = p @ v[:, j0:i1]
    return out.transpose(0, 1)


def swiglu(x, w_gu, w_down, precision):
    """``w_down(silu(x w_gate) · x w_up)`` with gate|up joined in
    ``w_gu``."""
    gu = mm(x, w_gu, precision)
    f = gu.shape[-1] // 2
    return mm(F.silu(gu[:, :f]) * gu[:, f:], w_down, precision)


def moe(h, lw, m, precision):
    """h ``[T, D]`` → the routed experts' weighted sum plus the shared
    experts' output."""
    scores = torch.sigmoid(h @ lw["router"])
    idx = torch.topk(scores + lw["router_bias"], m.top_k, dim=-1).indices
    gates = torch.gather(scores, -1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * m.route_scale
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=m.experts).tolist()
    tok = order // m.top_k
    weight = gates.reshape(-1)[order]
    out = torch.zeros_like(h)
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = tok[start:start + n]
            y = swiglu(h[rows], lw["we_gu"][e], lw["we_down"][e], precision)
            out.index_add_(0, rows, y * weight[start:start + n, None])
        start += n
    if "ws_gu" in lw:
        out = out + swiglu(h, lw["ws_gu"], lw["ws_down"], precision)
    return out


def layer(x, lw, positions, i, m, precision="fp32", block=1024):
    """Layer ``i`` on one sequence ``x [S, D]`` float32; ``lw`` holds the
    layer's weights (float32, the layout without the layer dim)."""
    S, D = x.shape
    window = m.window if m.sliding(i) else 0
    h = rmsnorm(x, lw["attn_norm"], m.eps)
    q, k, v = (mm(h, lw[w].reshape(D, -1), precision).view(S, -1,
                                                           m.head_dim)
               for w in ("wq", "wk", "wv"))
    q = rmsnorm(q, lw["q_norm"], m.eps)
    k = rmsnorm(k, lw["k_norm"], m.eps)
    if window:
        q = rope(q[None], positions, m.rope_theta)[0]
        k = rope(k[None], positions, m.rope_theta)[0]
    o = attention(q, k, v, window, block).reshape(S, -1)
    o = o * torch.sigmoid(mm(h, lw["w_attn_gate"].reshape(D, -1),
                             precision))
    x = x + rmsnorm(mm(o, lw["wo"].reshape(-1, D), precision),
                    lw["post_attn_norm"], m.eps)
    h = rmsnorm(x, lw["mlp_norm"], m.eps)
    if "w_gate" in lw:
        out = mm(F.silu(mm(h, lw["w_gate"], precision))
                 * mm(h, lw["w_up"], precision), lw["w_down"], precision)
    else:
        out = moe(h, lw, m, precision)
    return x + rmsnorm(out, lw["post_mlp_norm"], m.eps)


def layer_weights(params, i, m):
    """Layer ``i``'s leaves (its attention's and norms', and its MLP's
    from ``dense_mlp`` or ``moe_mlp``), in float32."""
    lw = {k: v[i] for k, v in params["layers"].items()}
    if i < m.dense_layers:
        lw.update({k: v[i] for k, v in params["dense_mlp"].items()})
    else:
        lw.update({k: v[i - m.dense_layers]
                   for k, v in params["moe_mlp"].items()})
    return {k: v.float() for k, v in lw.items()}


@torch.no_grad()
def served_logits(params, seqs, positions, m, precisions=("fp32",),
                  block=1024):
    """The logits at ``positions[j]`` of each token sequence ``seqs[j]``
    → ``{precision: [float32 [len(positions[j]), V]]}``. Each layer's
    weights are widened to float32 when it is used, one layer at a time,
    and every sequence passes through it before the next."""
    xs = {p: [params["embed"][s].float() * math.sqrt(m.d) for s in seqs]
          for p in precisions}
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for i in range(m.layers):
        lw = layer_weights(params, i, m)
        for p in precisions:
            xs[p] = [layer(x, lw, ps, i, m, p, block)
                     for x, ps in zip(xs[p], pos)]
        del lw
    head = params["head"].float()
    norm = params["final_norm"].float()
    return {p: [mm(rmsnorm(x[at], norm, m.eps), head, p)
                for x, at in zip(xs[p], positions)] for p in precisions}
