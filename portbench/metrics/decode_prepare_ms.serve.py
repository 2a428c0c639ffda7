"""``decode_prepare_ms.serve``: the host's side of a decode step before its
first launch (``compute/generate.py``): the block tables, lengths,
tokens and page writes built on the host — the growth of the engine's
``decode_prepare_seconds_total`` over its growth of ``decode_steps``
across the window less each traced stretch, in ms; nothing where
speculative rounds ran."""

from portbench.counters import per_decode_step_ms


def read(run, device):
    return per_decode_step_ms(run, "decode_prepare_seconds_total")
