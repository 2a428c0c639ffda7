"""``decode_sync_ms.serve``: the decode step's wait for its tokens
(``compute/generate.py``): the argmax's copy to the host, which waits
for the device to finish the step — the growth of the engine's
``decode_sync_seconds_total`` over its growth of ``decode_steps`` across
the window less each traced stretch, in ms; nothing where speculative
rounds ran."""

from portbench.counters import per_decode_step_ms


def read(run, device):
    return per_decode_step_ms(run, "decode_sync_seconds_total")
