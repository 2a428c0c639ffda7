"""``admit_ms.serve``: the engine loop's admission (``compute/generate.py``)
— the queue and slot sweeps, admission and the chunked prefills'
bookkeeping, less the prefill and import calls: the growth of the
engine's ``admit_seconds_total`` over its growth of ``iterations`` (the
loop's passes that did work) across the window less each traced
stretch, in ms."""

from portbench.counters import untraced_growth


def read(run, device):
    got = untraced_growth(run, "admit_seconds_total", "iterations")
    if got is None or not got[1]:
        return None
    return got[0] * 1e3 / got[1]
