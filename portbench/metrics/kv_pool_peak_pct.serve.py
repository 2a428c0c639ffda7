"""``kv_pool_peak_pct.serve``: the engine's paged KV pool
(``compute/generate.py``) in use — the most pages that the requests in
flight held at once inside the window (``readings.live_blocks_peak``,
from the client's records: each request's prompt and the tokens fed
back), over the pool's blocks, in %. Memory reserved and not in use
limits the batch, and so the tokens per second."""

from portbench.readings import live_blocks_peak


def read(run, device):
    eng = run.data["engine"]
    w0, w1 = run.data["window"]
    peak = live_blocks_peak(run.data["records"], eng["block_size"], w0, w1)
    return 100.0 * peak / eng["num_blocks"] if peak else None
