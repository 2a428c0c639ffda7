"""``gmm_roofline``: K6 and K7 (``ops/grouped_matmul.py``) in
a training step — the least time the card could take for the grouped
products that the routed rows need (``tokens · top_k`` rows, no
padding: the forward's gate|up and down, their dx and their dw, every
layer; recomputation not counted; ``roofline/kernels.py``) over K6 +
K7 device time a step, in %."""

from portbench import readings
from portbench.roofline import kernels


def read(run, device):
    pk, tr = readings.peaks(device), run.trace
    sh = run.data["shape"]
    if pk is None or tr is None or not sh.experts:
        return None
    secs = readings.group_seconds(tr, "K6 grouped_matmul",
                                  "K7 grouped_matmul_dw") \
        / run.data["traced_steps"]
    if not secs:
        return None
    rows = run.data["batch"] * run.data["seq"] * sh.top_k
    d, f, e, bm, dt = sh.d, sh.ffn, sh.experts, run.data["block_m"], \
        run.data["itemsize"]
    dtype = "bfloat16" if dt == 2 else "float32"
    calls = [kernels.gmm(rows, d, 2 * f, e, bm, dt),
             kernels.gmm(rows, f, d, e, bm, dt),
             kernels.gmm(rows, 2 * f, d, e, bm, dt),
             kernels.gmm(rows, d, f, e, bm, dt),
             kernels.gmm_dw(rows, d, 2 * f, e, bm, dt),
             kernels.gmm_dw(rows, f, d, e, bm, dt)]
    least = sum(kernels.bound(b, fl, dtype, pk)[0] for b, fl in calls)
    return 100.0 * least * sh.layers / secs
