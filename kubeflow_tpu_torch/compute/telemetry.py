"""Training-loop telemetry: live step time, MFU, and the goodput ledger.

Port of ``kubeflow_tpu/compute/telemetry.py``, booking the same family
names into the port's own registry (``kubeflow_tpu_torch/obs``):

- ``train_step_seconds{model}`` — per-step wall time histogram (the
  first step is excluded: it is start-up, accounted separately).
- ``train_mfu{model}`` — live MFU gauge: the caller's analytic
  flops-per-step over the EMA step time and the card's bf16 peak.
- ``train_compile_seconds_total{model}`` — wall time from workload
  start to the end of the first step (imports, kernel builds, the first
  step's allocations).
- ``train_goodput_seconds_total{gang,state}`` — the per-gang goodput
  ledger (``obs/goodput.py``): start-up as ``compile`` or ``restart``,
  steps as ``compute``, synchronous saves as ``checkpoint``.

A step's wall time is only a device time if the loop waits for the
card before ``step()``; an unsynchronised eager loop books enqueue time.
"""

import os
import time

from ..obs import metrics as obs_metrics
from ..obs.goodput import record_goodput

STEP_SECONDS = obs_metrics.REGISTRY.histogram(
    "train_step_seconds",
    "Training step wall time (compile step excluded)",
    ("model",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))

MFU_GAUGE = obs_metrics.REGISTRY.gauge(
    "train_mfu",
    "Live model FLOPs utilization (analytic flops/step over EMA step "
    "time and the card's bf16 peak)",
    ("model",))

COMPILE_SECONDS = obs_metrics.REGISTRY.counter(
    "train_compile_seconds_total",
    "Wall seconds from workload start to the end of the first step",
    ("model",))

#: dense bf16 tensor-core peaks (FLOP/s) by card name, NVIDIA's data
#: sheets: H100 SXM and H200 SXM 989e12, H100 PCIe 756e12
_PEAKS = (("h100 pcie", 756e12), ("h200", 989e12), ("h100", 989e12))


def peak_flops(device=None):
    """The card's dense bf16 peak FLOP/s, from its name
    (``torch.cuda.get_device_name``) — THE MFU denominator. Raises for a
    card it has no entry for rather than guess."""
    import torch
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAKS:
        if key in name:
            return peak
    raise ValueError(f"no bf16 peak known for {name!r}; pass peak= to "
                     f"TrainTelemetry")


def mesh_peak_flops(mesh):
    """The MFU denominator on a mesh: the sum of :func:`peak_flops` over
    the mesh's DISTINCT devices (one H100's for ``[cuda:0] * 4``, where
    four positions share one card), None when one is not a card."""
    devices = list(dict.fromkeys(mesh.devices))
    if any(d.type != "cuda" for d in devices):
        return None
    return sum(peak_flops(d) for d in devices)


class TrainTelemetry:
    """Per-workload telemetry feeder for a training loop.

    ``gang`` defaults to the ``OBS_GANG`` env the controllers inject;
    without one the goodput ledger is skipped and only the model-keyed
    families are fed. ``flops_per_step`` (analytic) enables the live
    MFU gauge; ``peak`` overrides :func:`peak_flops` (on a mesh, pass
    :func:`mesh_peak_flops`).

    The accounting mark starts at ``OBS_SPAWNED_AT`` (the runtime stamps
    the exec time into the child env) or object creation."""

    def __init__(self, model, gang=None, flops_per_step=None,
                 peak=None, resumed=False, ema=0.9):
        self.model = str(model)
        self.gang = gang if gang is not None \
            else os.environ.get("OBS_GANG")
        self.flops_per_step = flops_per_step
        self._peak = peak
        #: a resumed gang's time-to-first-step is restart recovery
        self.startup_state = "restart" if resumed else "compile"
        self._ema = float(ema)
        self.ema_step = None
        self._first_done = False
        spawned = os.environ.get("OBS_SPAWNED_AT")
        try:
            self._mark = float(spawned) if spawned else time.time()
        except ValueError:
            self._mark = time.time()

    def _peak_flops(self):
        """The MFU denominator: ``peak`` as given, else the card's; None
        on a host without CUDA (a CPU run has no MFU, so the gauge stays
        unset rather than show a number that is no device metric)."""
        if self._peak is None:
            import torch
            if not torch.cuda.is_available():
                return None
            self._peak = peak_flops()
        return self._peak

    def step(self, seconds=None):
        """Record one completed training step. The FIRST call closes the
        start-up window (mark → now) as compile/restart; later calls
        feed the step histogram, the goodput compute state and the live
        MFU gauge. ``seconds`` defaults to the time since the previous
        call."""
        now = time.time()
        elapsed = now - self._mark if seconds is None else float(seconds)
        if not self._first_done:
            self._first_done = True
            startup = now - self._mark
            COMPILE_SECONDS.labels(self.model).inc(startup)
            record_goodput(self.gang, self.startup_state, startup)
            self._mark = now
            return
        self._mark = now
        STEP_SECONDS.labels(self.model).observe(elapsed)
        record_goodput(self.gang, "compute", elapsed)
        self.ema_step = (elapsed if self.ema_step is None
                         else self._ema * self.ema_step
                         + (1 - self._ema) * elapsed)
        self._set_mfu()

    def _set_mfu(self):
        peak = self._peak_flops() if self.flops_per_step else None
        if peak and self.ema_step:
            MFU_GAUGE.labels(self.model).set(
                self.flops_per_step / self.ema_step / peak)

    def observe_steps(self, n, total_seconds):
        """Bulk-feed ``n`` equal steps (a loop that only waits for the
        card at its end has one real wall time, the total). Does not
        touch the first-step start-up classification."""
        if n <= 0:
            return
        per = float(total_seconds) / n
        for _ in range(int(n)):
            STEP_SECONDS.labels(self.model).observe(per)
            self.ema_step = (per if self.ema_step is None
                             else self._ema * self.ema_step
                             + (1 - self._ema) * per)
        record_goodput(self.gang, "compute", float(total_seconds))
        self._set_mfu()

    def checkpoint(self, seconds):
        """Wall time spent in a (synchronous) checkpoint save: booked as
        goodput ``checkpoint``; the step mark restarts so the save does
        not count in the next step's time."""
        self._mark = time.time()
        record_goodput(self.gang, "checkpoint", float(seconds))

    def live_mfu(self):
        return MFU_GAUGE.value(self.model)
