"""The per-gang goodput ledger — the one family both sides feed. The
port's own copy of ``kubeflow_tpu/obs/goodput.py``, booked into the
port's registry (``obs/metrics.py``).

Lives in obs/ (not compute/) because its writers span the platform:
the training loops record compute/compile/checkpoint/restart
(compute/telemetry.py wraps this with step timing and MFU), while the
admission scheduler (sched/controller.py) records queue_wait and
suspended — and the scheduler must not drag the whole jax stack into
its reconcile loop just to book seconds.
"""

from . import metrics as obs_metrics

#: goodput states — the ledger's closed vocabulary (dashboards and the
#: docs key on it; anything else is a bug, not a new state)
GOODPUT_STATES = ("compute", "compile", "checkpoint", "queue_wait",
                  "suspended", "restart")

GOODPUT = obs_metrics.REGISTRY.counter(
    "train_goodput_seconds_total",
    "Per-gang goodput ledger: admitted wall seconds by state "
    "(compute|compile|checkpoint|queue_wait|suspended|restart)",
    ("gang", "state"))


def record_goodput(gang, state, seconds):
    """One ledger entry; no-op without a gang identity (local runs)."""
    if not gang or seconds <= 0:
        return
    if state not in GOODPUT_STATES:
        raise ValueError(f"unknown goodput state {state!r}; expected "
                         f"one of {GOODPUT_STATES}")
    GOODPUT.labels(gang, state).inc(seconds)
