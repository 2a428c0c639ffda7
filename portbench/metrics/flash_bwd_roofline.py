"""``flash_bwd_roofline``: K4 and K5
(``ops/flash_attention.py``) in a training step — the least time the
card could take for the causal attention backward at the cell's shape
(every layer; ``roofline/kernels.py``) over K4 + K5 device time a step,
in %."""

from portbench import readings
from portbench.roofline import kernels


def read(run, device):
    pk, tr = readings.peaks(device), run.trace
    if pk is None or tr is None:
        return None
    secs = readings.group_seconds(tr, "K4 flash_bwd_dq", "K5 flash_bwd_dkv") \
        / run.data["traced_steps"]
    if not secs:
        return None
    sh, dt = run.data["shape"], run.data["itemsize"]
    dtype = "bfloat16" if dt == 2 else "float32"
    shape = (run.data["batch"], run.data["seq"], sh.heads, sh.kv_heads,
             sh.head_dim, True, dt)
    least = sum(kernels.bound(*f(*shape), dtype, pk)[0]
                for f in (kernels.flash_bwd_dq, kernels.flash_bwd_dkv))
    return 100.0 * least * sh.layers / secs
