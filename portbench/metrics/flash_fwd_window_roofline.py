"""``flash_fwd_window_roofline``: K3 (``ops/flash_attention.py``) in the
prefills of a model with windowed layers — the least time the card
could take for the attention of the prompts prefilled in the traced
stretch, each at its own length, over the band of a sliding layer's
window or the causal triangle of a global one (``roofline/afmoe.py``),
over K3's device time in the trace, in %; nothing for a model of
another family."""

from portbench import readings
from portbench.roofline import afmoe, kernels


def read(run, device):
    pk, tr, sh = readings.peaks(device), run.trace, run.data.get("afmoe")
    if pk is None or tr is None or sh is None:
        return None
    k3 = readings.group_seconds(tr, "K3 flash_fwd")
    lens = readings.prefills_in(run.data["records"], tr.t0, tr.t1)
    if not k3 or not lens:
        return None
    dt = run.data["itemsize"]
    dtype = "bfloat16" if dt == 2 else "float32"
    least = sum(n * kernels.bound(b, f, dtype, pk)[0] for p in lens
                for b, f, n in afmoe.flash_fwd_window(sh, p, dt))
    return 100.0 * least / k3
