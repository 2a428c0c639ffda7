"""``queue_wait_ms.serve``: a request's wait in the engine's queue
(``compute/generate.py``), from its submit to its admission into a slot
— the growth of the engine's ``queue_wait_seconds_total`` over its
growth of ``admissions`` across the window less each traced stretch, in
ms."""

from portbench.counters import untraced_growth


def read(run, device):
    got = untraced_growth(run, "queue_wait_seconds_total", "admissions")
    if got is None or not got[1]:
        return None
    return got[0] * 1e3 / got[1]
