"""``decode_step_ms.serve``: the engine's decode step
(``compute/generate.py``) — the growth of the engine's
``decode_seconds_total`` over its growth of ``decode_steps`` across the
window, in ms; in a traced run across the window less each traced
stretch (from its start to its profiler's stop)."""


def read(run, device):
    s0, s1 = run.data["stats"]
    marks = [s0]
    for before, after in run.data["stretches"]:
        marks += [before, after]
    marks.append(s1)
    parts = list(zip(marks[::2], marks[1::2]))
    steps = sum(e["decode_steps"] - s["decode_steps"] for s, e in parts)
    secs = sum(e["decode_seconds_total"] - s["decode_seconds_total"]
               for s, e in parts)
    return secs * 1e3 / steps if steps else None
