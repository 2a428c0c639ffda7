"""``paged_decode_window_roofline``: K1 (``ops/paged_attention.py``, the
split key walk and its combine) in the decode steps of a model with
windowed layers — the least time the card could take to read the K/V
that the served lengths need, each byte once: every decode row whose
token arrived in the traced stretch, on a sliding layer the last
``sliding_window`` positions, on a global layer all of them
(``roofline/afmoe.py``), over K1's device time in the trace, in %;
nothing for a model of another family."""

from portbench import readings
from portbench.roofline import afmoe, kernels


def read(run, device):
    pk, tr, sh = readings.peaks(device), run.trace, run.data.get("afmoe")
    if pk is None or tr is None or sh is None:
        return None
    k1 = readings.group_seconds(tr, "K1 paged_decode")
    rows = readings.decode_rows_in(run.data["records"], tr.t0, tr.t1)
    if not k1 or not rows:
        return None
    dt, eng = run.data["itemsize"], run.data["engine"]
    table = -(-eng["max_context"] // eng["block_size"])
    dtype = "bfloat16" if dt == 2 else "float32"
    least = sum(n * kernels.bound(b, f, dtype, pk)[0] for b, f, n in
                afmoe.paged_decode_window(sh, rows, table, dt))
    return 100.0 * least / k1
