"""The AFMoE family's arithmetic (Arcee's Trinity: windowed and global
attention layers, leading dense layers, routed experts with a shared
one), from a configuration's published keys: its model FLOPs a prefill
and a decoded token, and the bytes and operations of K1, K3 and K6 as
its layers call them.

Counted as ``model_flops.py`` counts a dense model's: the matmul
parameters a token passes through (q, k, v, the attention gate, o; the
dense SwiGLU, or the router, the top-k experts and the shared expert;
the LM head on the position whose logits choose a token; not the
embedding lookup or the norms), and attention over the pairs present —
on a sliding layer only the pairs inside its window."""

import dataclasses

from . import kernels


@dataclasses.dataclass(frozen=True)
class Afmoe:
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int               # the leading dense layers' SwiGLU width
    expert_ffn: int
    experts: int
    top_k: int
    shared: int            # shared experts (each of expert_ffn)
    dense_layers: int
    window: int
    global_every: int
    vocab: int

    @classmethod
    def of(cls, config):
        heads = config["num_attention_heads"]
        return cls(d=config["hidden_size"],
                   layers=config["num_hidden_layers"], heads=heads,
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config.get("head_dim")
                   or config["hidden_size"] // heads,
                   ffn=config["intermediate_size"],
                   expert_ffn=config["moe_intermediate_size"],
                   experts=config["num_experts"],
                   top_k=config["num_experts_per_tok"],
                   shared=config.get("num_shared_experts") or 0,
                   dense_layers=config.get("num_dense_layers") or 0,
                   window=config.get("sliding_window") or 0,
                   global_every=config.get("global_attn_every_n_layers")
                   or 0, vocab=config["vocab_size"])

    def layer_window(self, i):
        if not self.window or (self.global_every
                               and (i + 1) % self.global_every == 0):
            return 0
        return self.window

    @property
    def sliding_layers(self):
        return sum(1 for i in range(self.layers) if self.layer_window(i))

    @property
    def global_layers(self):
        return self.layers - self.sliding_layers

    @property
    def moe_layers(self):
        return self.layers - self.dense_layers

    def attn_params(self):
        """q, k, v, the output gate and o of one layer."""
        return self.d * (3 * self.heads + 2 * self.kv_heads) * self.head_dim

    def moe_active_params(self):
        """The router, the top-k experts and the shared experts."""
        return (self.d * self.experts
                + (self.top_k + self.shared) * 3 * self.d * self.expert_ffn)

    def body_params(self):
        return (self.layers * self.attn_params()
                + self.dense_layers * 3 * self.d * self.ffn
                + self.moe_layers * self.moe_active_params())

    def head_params(self):
        return self.d * self.vocab

    def attn_flops(self, pairs):
        """QKᵀ and PV of one layer over ``pairs`` (query, key) pairs."""
        return 4 * self.heads * self.head_dim * pairs


def band_pairs(seq, window):
    """(query, key) pairs of a causal sequence of ``seq`` positions whose
    keys lie within ``window`` of their query (0: every causal pair)."""
    if not window or seq <= window:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def _over_layers(shape, fn):
    """``fn(window)`` summed over the layers: the sliding layers at the
    window, the global ones at 0."""
    return (shape.sliding_layers * fn(shape.window)
            + shape.global_layers * fn(0))


def prefill_flops(shape, prompt_len):
    """One prompt's forward: every position through the layers, its
    attention pairs (banded on the sliding layers), the head on the
    last position."""
    return (2 * shape.body_params() * prompt_len
            + _over_layers(shape, lambda w: shape.attn_flops(
                band_pairs(prompt_len, w)))
            + 2 * shape.head_params())


def decode_token_flops(shape, context):
    """One generated token over ``context`` positions (its own
    included): the layers, attention over its window or the whole
    context, the head."""
    return (2 * shape.body_params()
            + _over_layers(shape, lambda w: shape.attn_flops(
                min(context, w) if w else context))
            + 2 * shape.head_params())


def paged_decode_window(shape, contexts, table_len, itemsize=2):
    """K1 over a model's layers for decode rows that read ``contexts``
    positions each (their own included) → ``[(bytes, flops, layers)]``:
    the sliding layers read the last ``window`` positions of each, the
    global layers all of them (``kernels.paged_decode`` per layer)."""
    rows = len(contexts)
    out = []
    for w, n in ((shape.window, shape.sliding_layers),
                 (0, shape.global_layers)):
        if n:
            pos = sum(min(c, w) if w else c for c in contexts)
            out.append((*kernels.paged_decode(
                pos, rows, shape.heads, shape.kv_heads, shape.head_dim,
                table_len, itemsize), n))
    return out


def flash_fwd_window(shape, prompt_len, itemsize=2):
    """K3 over a model's layers for one prompt → ``[(bytes, flops,
    layers)]``: q read and out written, k and v read once, the fp32 row
    statistics written; QKᵀ and PV over the band's pairs on a sliding
    layer, the causal pairs on a global one."""
    H, KV, D = shape.heads, shape.kv_heads, shape.head_dim
    q = prompt_len * H * D
    kv = prompt_len * KV * D
    nbytes = (2 * q + 2 * kv) * itemsize + H * prompt_len * 4
    out = []
    for w, n in ((shape.window, shape.sliding_layers),
                 (0, shape.global_layers)):
        if n:
            out.append((nbytes, 4 * D * H * band_pairs(prompt_len, w), n))
    return out


def gmm_serve(shape, rows, active, itemsize=2):
    """K6 in serving over ``rows`` token-expert rows and ``active``
    experts with a row (both summed over expert layer calls) → ``[(bytes,
    flops)]`` of the two products, gate|up (``d`` to ``2·f``) and down
    (``f`` to ``d``): each routed row read and its output written once,
    each active expert's weight read once, one product a row."""
    d, f = shape.d, shape.expert_ffn
    return [((rows * (k + n) + active * k * n) * itemsize, 2 * rows * k * n)
            for k, n in ((d, 2 * f), (f, d))]
