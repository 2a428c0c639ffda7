"""``idle_pct.train``: the card (H100) in the training steps — the
share of the traced steps in which no device operation ran (the union
of their intervals), in %."""

from portbench import readings


def read(run, device):
    if readings.peaks(device) is None or run.trace is None:
        return None
    busy, _ = run.trace.busy()
    return 100.0 * (1.0 - busy / run.trace.window_s)
