"""``decode_launch_ms.serve``: the decode step's launches
(``compute/generate.py``): from the step's start until its argmax is
queued — the growth of the engine's ``decode_launch_seconds_total``
over its growth of ``decode_steps`` across the window less each traced
stretch, in ms; nothing where speculative rounds ran."""

from portbench.counters import per_decode_step_ms


def read(run, device):
    return per_decode_step_ms(run, "decode_launch_seconds_total")
