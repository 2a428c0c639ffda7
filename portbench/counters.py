"""Growth of the engine's counters over the undisturbed window: from the
window's opening to the first traced stretch's start, from each
stretch's stop to the next start, and from the last stop to the window's
close (``run.data["stats"]`` and ``run.data["stretches"]``, the
engine's ``stats`` at each mark)."""


def untraced_growth(run, *keys):
    """The summed growth of each of ``keys`` over the untraced parts of
    the window → a tuple, or None where the engine does not book one of
    them."""
    s0, s1 = run.data["stats"]
    if any(k not in s0 for k in keys):
        return None
    marks = [s0]
    for before, after in run.data["stretches"]:
        marks += [before, after]
    marks.append(s1)
    parts = list(zip(marks[::2], marks[1::2]))
    return tuple(sum(e[k] - s[k] for s, e in parts) for k in keys)


def per_decode_step_ms(run, key):
    """``key``'s growth over the decode steps' growth, in ms; None
    without plain decode steps, or where speculative rounds (which book
    only ``decode_seconds_total``) ran."""
    got = untraced_growth(run, key, "decode_steps", "spec_rounds")
    if got is None:
        return None
    secs, steps, spec = got
    return secs * 1e3 / steps if steps and not spec else None
