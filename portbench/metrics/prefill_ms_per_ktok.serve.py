"""``prefill_ms_per_ktok.serve``: the engine's prefill time
(``compute/generate.py``) per thousand prompt tokens — the done
frames' ``prefill_s`` of the requests due in the window over their
prompt tokens, in ms per 1000 tokens. Requests that overlap the traced
stretch are left out (``readings.untraced_requests``)."""

from portbench.readings import untraced_requests


def read(run, device):
    rs = [r for r in untraced_requests(run)
          if r["done"].get("prefill_s") is not None]
    tokens = sum(r["prompt_len"] for r in rs)
    if not tokens:
        return None
    return sum(r["done"]["prefill_s"] for r in rs) * 1e3 / (tokens / 1e3)
