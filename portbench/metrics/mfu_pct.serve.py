"""``mfu_pct.serve``: the whole served model's share of the card's
peak (``models/transformer.py``) — the model FLOPs of the prompts
prefilled and the tokens decoded in the traced stretch
(``roofline/model_flops.py``) over its seconds and the bf16 peak, in
%."""

from portbench import readings


def read(run, device):
    pk, tr = readings.peaks(device), run.trace
    if pk is None or tr is None:
        return None
    pre, dec = readings.served_flops(run.data["shape"], run.data["records"],
                                     tr.t0, tr.t1)
    if not pre + dec:
        return None
    return 100.0 * (pre + dec) / (tr.window_s * pk[0]["bfloat16"])
