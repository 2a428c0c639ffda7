"""``mfu_pct.computed.serve``: the whole served model's share of the
card's peak counting only the prefill work done (``models/
transformer.py``) — the model FLOPs of the prompt positions the
prefills of the traced stretch computed (the growth of the engine's
``prefill_tokens_total``, ``prefill_attn_pairs_total`` and ``prefills``
over it: a prefix hit's cached positions are read, not computed;
``roofline/prefill_work.py``) and of the tokens decoded in it, over its
seconds and the bf16 peak, in %; nothing where the engine does not
count its prefill work."""

from portbench import readings
from portbench.roofline import prefill_work


def read(run, device):
    pk, tr, st = readings.peaks(device), run.trace, run.data.get("trace_stats")
    sh = run.data.get("shape")
    if pk is None or tr is None or st is None or sh is None \
            or "prefill_tokens_total" not in st[0]:
        return None
    s0, s1 = st
    pre = prefill_work.computed_prefill_flops(
        sh, *(s1[k] - s0[k] for k in ("prefill_tokens_total",
                                      "prefill_attn_pairs_total",
                                      "prefills")))
    _, dec = readings.served_flops(sh, run.data["records"], tr.t0, tr.t1)
    if not pre + dec:
        return None
    return 100.0 * (pre + dec) / (tr.window_s * pk[0]["bfloat16"])
