"""``flash_fwd_roofline``: K3 (``ops/flash_attention.py``) in
the prefills — the least time the card could take for the causal
attention of the prompts prefilled in the traced stretch (each at its
own length, every layer; ``roofline/kernels.py``) over K3's device time
in the trace, in %."""

from portbench import readings
from portbench.roofline import kernels


def read(run, device):
    pk, tr = readings.peaks(device), run.trace
    if pk is None or tr is None:
        return None
    k3 = readings.group_seconds(tr, "K3 flash_fwd")
    sh, dt = run.data["shape"], run.data["itemsize"]
    lens = readings.prefills_in(run.data["records"], tr.t0, tr.t1)
    if not k3 or not lens:
        return None
    least = sum(kernels.bound(*kernels.flash_fwd(
        1, p, sh.heads, sh.kv_heads, sh.head_dim, True, dt),
        "bfloat16" if dt == 2 else "float32", pk)[0] for p in lens)
    return 100.0 * least * sh.layers / k3
