"""Reductions the per-layer readers share: which served work fell inside
a traced stretch, read from the client's records.

A request's prefill ends just before its first token frame arrives and
lasted the ``prefill_s`` its done frame reports; it belongs to a stretch
when its midpoint does. A token frame after the first comes from one
decode step, which read the prompt and every token before it (``prompt
+ index`` positions); it belongs to a stretch when it arrives inside."""

from .roofline import peaks_for
from .roofline.model_flops import decode_token_flops, prefill_flops


def peaks(device):
    return peaks_for(device.get("kind")) if device.get("platform") == "gpu" \
        else None


def prefills_in(records, t0, t1):
    """Prompt lengths of the prefills inside ``[t0, t1)``."""
    out = []
    for r in records:
        d = r.get("done")
        if not r["times"] or d is None or d.get("prefill_s") is None:
            continue
        mid = r["times"][0] - d["prefill_s"] / 2
        if t0 <= mid < t1:
            out.append(r["prompt_len"])
    return out


def decode_rows_in(records, t0, t1):
    """Positions read by each decode row whose token arrived inside
    ``[t0, t1)``."""
    return [r["prompt_len"] + i for r in records
            for i, t in enumerate(r["times"]) if i and t0 <= t < t1]


def served_flops(shape, records, t0, t1):
    """Model FLOPs of the prompts prefilled and the tokens decoded
    inside ``[t0, t1)``: ``(prefill, decode)``."""
    return (sum(prefill_flops(shape, p) for p in prefills_in(records, t0, t1)),
            sum(decode_token_flops(shape, c)
                for c in decode_rows_in(records, t0, t1)))


def untraced_requests(run):
    """The window's finished requests whose time to first token (send to
    first token frame) lies wholly outside the traced stretch and the
    profiler's start and stop: the readings that need no trace are taken
    over these, undisturbed by the tracing."""
    spans = run.data["untraced"]
    return [r for r in run.data["records"]
            if r["phase"] == "window" and r["times"] and r["done"]
            and any(a <= r["send"] and r["times"][0] < b for a, b in spans)]


def group_seconds(trace, *groups):
    return sum(trace.seconds_in(g) for g in groups)


def live_blocks_peak(records, block_size, t0, t1):
    """The most KV pages that the requests in flight held at once inside
    ``[t0, t1)``: a request holds its prompt's pages from the start of
    its prefill (its first token frame less the done frame's
    ``prefill_s``; a request waiting for pages in the engine's queue
    holds none), and one page more each time the tokens fed back fill
    one (the token whose frame arrived is written at the next step),
    until its last token frame."""
    events = []
    for r in records:
        if not r["times"]:
            continue
        start = r["times"][0] - ((r["done"] or {}).get("prefill_s") or 0.0)
        held = -(-r["prompt_len"] // block_size)
        events.append((start, held))
        for i, t in enumerate(r["times"]):
            pages = -(-(r["prompt_len"] + i) // block_size)
            if pages > held:
                events.append((t, pages - held))
                held = pages
        events.append((r["times"][-1], -held))
    events.sort(key=lambda e: e[0])
    live = peak = 0
    for t, d in events:
        live += d
        if t0 <= t < t1:
            peak = max(peak, live)
    return peak
