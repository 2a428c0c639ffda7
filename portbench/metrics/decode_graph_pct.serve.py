"""``decode_graph_pct.serve``: how often the engine's plain decode step
(``compute/generate.py``) ran as a replay of its captured CUDA graph —
the growth of the engine's ``decode_graph_replays`` over its growth of
``decode_steps`` across the window less each traced stretch, in %;
nothing where the engine books no replays."""

from portbench.counters import untraced_growth


def read(run, device):
    got = untraced_growth(run, "decode_graph_replays", "decode_steps")
    if got is None:
        return None
    replays, steps = got
    return 100.0 * replays / steps if steps else None
