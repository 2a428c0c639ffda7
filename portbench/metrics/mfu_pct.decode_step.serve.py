"""``mfu_pct.decode_step.serve``: the decode step's share of the card's
peak (``compute/generate.py`` over ``models/transformer.py``) — the
model FLOPs of the tokens decoded in the traced stretch over the
engine's decode seconds in it (``decode_seconds_total``) and the bf16
peak, in %. It bounds K1's roofline share from above: a kernel taken off
the decode path leaves this one to read."""

from portbench import readings


def read(run, device):
    pk, tr = readings.peaks(device), run.trace
    if pk is None or tr is None or run.data.get("trace_stats") is None:
        return None
    s0, s1 = run.data["trace_stats"]
    secs = s1["decode_seconds_total"] - s0["decode_seconds_total"]
    _, dec = readings.served_flops(run.data["shape"], run.data["records"],
                                   tr.t0, tr.t1)
    if not secs or not dec:
        return None
    return 100.0 * dec / (secs * pk[0]["bfloat16"])
