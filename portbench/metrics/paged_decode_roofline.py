"""``paged_decode_roofline``: K1 (``ops/paged_attention.py``,
the split key walk and its combine) in the decode steps — the least
time the card could take to read the K/V that the served lengths need,
each byte once (every decode row whose token arrived in the traced
stretch, every layer; ``roofline/kernels.py``), over K1's device time
in the trace, in %."""

from portbench import readings
from portbench.roofline import kernels


def read(run, device):
    pk, tr = readings.peaks(device), run.trace
    if pk is None or tr is None:
        return None
    k1 = readings.group_seconds(tr, "K1 paged_decode")
    rows = readings.decode_rows_in(run.data["records"], tr.t0, tr.t1)
    if not k1 or not rows:
        return None
    sh, dt, eng = run.data["shape"], run.data["itemsize"], run.data["engine"]
    table = -(-eng["max_context"] // eng["block_size"])
    nbytes, flops = kernels.paged_decode(sum(rows), len(rows), sh.heads,
                                         sh.kv_heads, sh.head_dim, table, dt)
    least = kernels.bound(nbytes, flops,
                          "bfloat16" if dt == 2 else "float32", pk)[0]
    return 100.0 * least * sh.layers / k1
