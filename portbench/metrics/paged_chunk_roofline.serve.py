"""``paged_chunk_roofline.serve``: K2 (``ops/paged_attention.py``'s chunk
read) in the prefills after a prefix hit — the least time the card
could take for the K2 calls of the traced stretch (the growth of the
engine's ``prefill_cached_tokens_total``, ``prefill_cached_prefix_total``
and ``prefill_cached_attn_pairs_total`` over it: each query row read and
written once, each cached and new K/V row read once, every layer;
``roofline/prefill_work.py``) over K2's device time in the trace, in %;
nothing where the engine books no such calls."""

from portbench import readings
from portbench.roofline import kernels, prefill_work

KEYS = ("prefill_cached_tokens_total", "prefill_cached_prefix_total",
        "prefill_cached_attn_pairs_total")


def read(run, device):
    pk, tr, st = readings.peaks(device), run.trace, run.data.get("trace_stats")
    sh = run.data.get("shape")
    if pk is None or tr is None or st is None or sh is None \
            or KEYS[0] not in st[0]:
        return None
    tokens, prefix, pairs = (st[1][k] - st[0][k] for k in KEYS)
    k2 = readings.group_seconds(tr, "K2 paged_chunk")
    if not k2 or not tokens:
        return None
    dt = run.data["itemsize"]
    nbytes, flops = prefill_work.paged_chunk(
        tokens, prefix, pairs, sh.heads, sh.kv_heads, sh.head_dim, dt)
    least = kernels.bound(nbytes, flops,
                          "bfloat16" if dt == 2 else "float32", pk)[0]
    return 100.0 * least * sh.layers / k2
