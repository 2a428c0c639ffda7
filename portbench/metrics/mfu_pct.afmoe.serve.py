"""``mfu_pct.afmoe.serve``: the whole served AFMoE model's share of the
card's peak (``models/transformer.py``'s AFMoE layers) — the model FLOPs
of the prompts prefilled and the tokens decoded in the traced stretch
(``roofline/afmoe.py``: the active experts, banded attention on the
sliding layers) over its seconds and the bf16 peak, in %; nothing for a
model of another family."""

from portbench import readings
from portbench.roofline import afmoe


def read(run, device):
    pk, tr, sh = readings.peaks(device), run.trace, run.data.get("afmoe")
    if pk is None or tr is None or sh is None:
        return None
    recs = run.data["records"]
    flops = (sum(afmoe.prefill_flops(sh, p)
                 for p in readings.prefills_in(recs, tr.t0, tr.t1))
             + sum(afmoe.decode_token_flops(sh, c)
                   for c in readings.decode_rows_in(recs, tr.t0, tr.t1)))
    if not flops:
        return None
    return 100.0 * flops / (tr.window_s * pk[0]["bfloat16"])
