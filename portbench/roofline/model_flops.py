"""Model FLOPs of a decoder-only transformer, from a configuration's
published keys (``hidden_size``, ``num_hidden_layers``,
``num_attention_heads``, ``num_key_value_heads``, ``intermediate_size``,
``vocab_size``, and for a mixture of experts ``num_local_experts`` and
``num_experts_per_tok``).

The port's ``transformer.flops_per_token`` (JAX's formula) counts
``6·N`` with every parameter once — the dense MLP once whatever the
experts — and attention as ``12·layers·d_model·max_seq``. This copy
counts what a token needs: the matmul parameters it passes through (the
top-k experts of each expert layer, the router, the LM head; not the
embedding lookup or the norms), and attention over the causal pairs
actually present. Recomputation (remat) is never counted."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    experts: int = 0
    top_k: int = 0

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
                   experts=config.get("num_local_experts") or 0,
                   top_k=config.get("num_experts_per_tok") or 0)

    def layer_matmul_params(self):
        """Parameters a token multiplies by in one layer: q, k, v, o and
        the MLP (top-k experts and the router, or the dense SwiGLU)."""
        attn = self.d * (2 * self.heads + 2 * self.kv_heads) * self.head_dim
        if self.experts:
            mlp = self.top_k * 3 * self.d * self.ffn + self.d * self.experts
        else:
            mlp = 3 * self.d * self.ffn
        return attn + mlp

    def body_params(self):
        return self.layers * self.layer_matmul_params()

    def head_params(self):
        return self.d * self.vocab

    def attn_forward_flops(self, pairs):
        """QKᵀ and PV of one layer over ``pairs`` (query, key) pairs."""
        return 4 * self.heads * self.head_dim * pairs


def causal_pairs(seq):
    return seq * (seq + 1) // 2


def train_step_flops(shape, batch, seq):
    """Forward and backward of one step over ``batch × seq`` tokens:
    ``6 · (body + head) · tokens`` plus causal attention, forward and
    backward (``3×`` the forward's ``4·H·D`` per pair), every layer."""
    tokens = batch * seq
    dense = 6 * (shape.body_params() + shape.head_params()) * tokens
    attn = 3 * shape.layers * shape.attn_forward_flops(
        batch * causal_pairs(seq))
    return dense + attn


def prefill_flops(shape, prompt_len):
    """The forward of one prompt: every position through the layers,
    causal attention, and the LM head on the last position (the one
    whose logits choose the first token)."""
    return (2 * shape.body_params() * prompt_len
            + shape.layers * shape.attn_forward_flops(
                causal_pairs(prompt_len))
            + 2 * shape.head_params())


def decode_token_flops(shape, context):
    """One generated token that attends over ``context`` positions (its
    own included): the layers, attention over the context, the head."""
    return (2 * shape.body_params()
            + shape.layers * shape.attn_forward_flops(context)
            + 2 * shape.head_params())
