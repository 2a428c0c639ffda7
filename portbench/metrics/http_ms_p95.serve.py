"""``http_ms_p95.serve``: the HTTP plane's share of time to first token
(``compute/serving.py``, ``serving_async.py``) — per finished request
due in the window, the client's time from its send to its first token
frame less the engine's own ``ttft_s`` (submit → first token, from the
done frame), the 95th percentile, in ms. Requests that overlap the
traced stretch are left out (``readings.untraced_requests``)."""

from portbench.readings import untraced_requests
from portbench.runners.common import percentile


def read(run, device):
    vals = [(r["times"][0] - r["send"] - r["done"]["ttft_s"]) * 1e3
            for r in untraced_requests(run)
            if r["done"].get("ttft_s") is not None]
    return percentile(vals, 95) if vals else None
