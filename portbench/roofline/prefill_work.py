"""A served dense model's prefill work as the engine counts it
(``compute/generate.py``'s ``prefill_tokens_total`` and
``prefill_attn_pairs_total`` over every prefill call, and the K2 calls'
``prefill_cached_tokens_total``, ``prefill_cached_prefix_total`` and
``prefill_cached_attn_pairs_total``): the model FLOPs of the prompt
positions actually computed — a prefix hit's cached positions are read,
not computed — and K2's bytes and operations over its calls.

Sums over calls, so :func:`kernels.bound` of a sum is the least time of
calls that share one regime; where calls differ it reads low, never
high."""


def computed_prefill_flops(shape, tokens, pairs, calls):
    """``calls`` prefill calls that computed ``tokens`` prompt positions
    attending ``pairs`` causal (query, key) pairs (``model_flops.Shape``
    ``shape``): every computed position through the layers, attention
    over the pairs, the LM head on each call's last position."""
    return (2 * shape.body_params() * tokens
            + shape.layers * shape.attn_forward_flops(pairs)
            + 2 * shape.head_params() * calls)


def paged_chunk(tokens, prefix, pairs, heads, kv_heads, head_dim,
                itemsize=2):
    """K2 in one layer over calls that computed ``tokens`` query rows
    after ``prefix`` cached positions and attended ``pairs`` pairs: q
    read and out written, the prefix's K and V rows read once, the
    calls' own k and v read; QKᵀ and PV over the pairs."""
    nbytes = (2 * tokens * heads * head_dim
              + 2 * (prefix + tokens) * kv_heads * head_dim) * itemsize
    return nbytes, 4 * heads * head_dim * pairs
