"""``decode_emit_ms.serve``: the decode step's per-row emission
(``compute/generate.py``): each row's latency books, token, ``on_token``
callback and eviction after the step — the growth of the engine's
``decode_emit_seconds_total`` over its growth of ``decode_steps`` across
the window less each traced stretch, in ms; nothing where speculative
rounds ran."""

from portbench.counters import per_decode_step_ms


def read(run, device):
    return per_decode_step_ms(run, "decode_emit_seconds_total")
