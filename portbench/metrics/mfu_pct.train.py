"""``mfu_pct.train``: the whole training step's share of the card's
peak (``models/transformer.py`` through ``compute/train.py``) — the
model FLOPs of a step (``6 · active parameters · tokens`` plus causal
attention, forward and backward, no recomputation;
``roofline/model_flops.py``) over the traced steps' seconds a step and
the bf16 peak, in %."""

from portbench import readings
from portbench.roofline.model_flops import train_step_flops


def read(run, device):
    pk, tr = readings.peaks(device), run.trace
    if pk is None or tr is None:
        return None
    step_s = tr.window_s / run.data["traced_steps"]
    flops = train_step_flops(run.data["shape"], run.data["batch"],
                             run.data["seq"])
    return 100.0 * flops / (step_s * pk[0]["bfloat16"])
