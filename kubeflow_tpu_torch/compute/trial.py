"""StudyJob trial entrypoint — the workload side of the HPO contract.

Port of ``kubeflow_tpu/compute/trial.py``. The controller substitutes
parameters into the trial template, and a trial completes when its
metrics carry the objective. Workload side (this module):

- ``params()``: read hyperparameters from TRIAL_PARAMETERS (JSON env)
  or individual TRIAL_PARAM_<NAME> vars,
- ``report(value)``: write the objective where the collector looks — a
  JSON file at METRICS_PATH (default: ``trial-metrics.json`` in the
  temporary directory, which follows TMPDIR) plus a parseable stdout line
  (``trial-metric {"name": ..., "value": ...}``, the log-scrape
  contract),
- ``run_mnist_trial()``: the default objective, the MLP on a fixed
  synthetic MNIST batch, under the fleet telemetry of the JAX module:
  the shard exporter (``obs/export.py``) runs for the whole trial and
  the training loop is one ``trial`` span (``obs/tracing.py``) that
  continues the controller's ``TRACEPARENT``.
"""

import json
import os
import tempfile

METRIC_LINE_PREFIX = "trial-metric "

#: the default objective's hyperparameters
MNIST_DEFAULTS = {"lr": 1e-2, "hidden": 64, "weight_decay": 0.01,
                  "clip_norm": 1.0}


def params(defaults=None):
    out = dict(defaults or {})
    blob = os.environ.get("TRIAL_PARAMETERS")
    if blob:
        out.update(json.loads(blob))
    for key, value in os.environ.items():
        if key.startswith("TRIAL_PARAM_"):
            name = key[len("TRIAL_PARAM_"):].lower()
            try:
                out[name] = json.loads(value)
            except (ValueError, TypeError):
                out[name] = value
    return out


def report(value, name=None, extra=None, step=None, trial=None):
    """Report the objective. With ``step`` this is an INTERMEDIATE
    report (per-epoch progress): it goes to stdout only and feeds the
    early-stopping service — the collector never mistakes it for the
    final objective. Without ``step`` it is the final report, written to
    METRICS_PATH too.

    ``trial`` routes the line in a vectorized sweep pod running many
    trials (``compute/sweep.py``): the payload carries the trial index
    and METRICS_PATH is skipped (one file cannot serve K trials; the
    stdout line is the sweep contract). Single-trial reports
    (``trial=None``) are byte-identical to the JAX package's."""
    name = name or os.environ.get("TRIAL_OBJECTIVE_NAME", "objective")
    payload = {"name": name, "value": float(value)}
    if step is not None:
        payload["step"] = int(step)
    if trial is not None:
        payload["trial"] = int(trial)
    if extra:
        payload["extra"] = {k: float(v) for k, v in extra.items()}
    print(METRIC_LINE_PREFIX + json.dumps(payload), flush=True)
    if step is not None or trial is not None:
        return payload
    path = os.environ.get("METRICS_PATH") or os.path.join(
        tempfile.gettempdir(), "trial-metrics.json")   # follows TMPDIR
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({name: float(value),
                       **(payload.get("extra") or {})}, f)
    except OSError:
        pass  # read-only fs: the stdout line remains authoritative
    return payload


def parse_metric_line(line):
    """Collector side of the stdout contract; None if not a metric."""
    line = line.strip()
    if not line.startswith(METRIC_LINE_PREFIX):
        return None
    try:
        return json.loads(line[len(METRIC_LINE_PREFIX):])
    except ValueError:
        return None


def mnist_batch(device):
    """The mnist objective's fixed data: 64 standard-normal 28×28×1
    images and labels in [0, 10) from seed 1, the same for a lone trial
    and for every trial of a sweep. (The port's own numbers: JAX draws
    its batch from ``jax.random``.)"""
    import torch
    g = torch.Generator().manual_seed(1)
    return {"image": torch.randn((64, 28, 28, 1), generator=g).to(device),
            "label": torch.randint(0, 10, (64,), generator=g).to(device)}


def run_mnist_trial(hp=None, steps=30, device=None):
    """Default objective: MLP on synthetic MNIST; returns final loss.
    ``device`` None → the card."""
    from ..obs import export as obs_export
    from ..obs import tracing
    from . import telemetry as telem

    # telemetry first: the start-up window in the goodput ledger should
    # include the torch import and the device's start (the real cost of
    # a cold trial pod), and the exporter publishes even a crashed
    # trial's partial state
    exporter = obs_export.start_exporter()
    tele = telem.TrainTelemetry("mnist-mlp")

    import torch

    from . import device as device_lib
    from . import train
    from .models import mlp

    dev = device_lib.resolve(device)
    hp = params(dict(MNIST_DEFAULTS, **(hp or {})))
    cfg = mlp.Config(in_dim=784, hidden=int(hp["hidden"]), n_classes=10)
    # every continuous knob the vectorized sweep threads per-trial
    # (compute/sweep.py CONTINUOUS_KEYS) is honored here too — the
    # "vectorized K trials == K independent trials" invariant requires
    # the two paths to build the identical optimizer
    opt = train.make_optimizer(learning_rate=float(hp["lr"]),
                               warmup_steps=2, total_steps=steps,
                               weight_decay=float(hp["weight_decay"]),
                               clip_norm=float(hp["clip_norm"]))
    state = train.init_state(
        lambda g, device: mlp.init_params(cfg, g, device=device), opt,
        device=dev, generator=torch.Generator().manual_seed(0))
    step = train.make_train_step(train.plain_loss(mlp.loss_fn, cfg), opt)
    batch = mnist_batch(dev)
    # arm the live train_mfu gauge now that the model shape is known
    # (6ND convention; the gauge stays unset on a host without a card)
    tele.flops_per_step = 6.0 * mlp.param_count(cfg) \
        * batch["image"].shape[0]

    def batches():
        for _ in range(steps):
            yield batch

    # train.fit wraps the source in a Prefetcher under its context
    # manager: the pump thread is joined even if a step raises, so a
    # failed trial never leaks a thread wedged on the batch queue.
    # The root span continues the controller-injected TRACEPARENT so
    # the trial's timeline stitches onto the StudyJob's gang trace.
    try:
        with tracing.span("trial", traceparent=os.environ.get(
                "TRACEPARENT"), steps=steps):
            state, metrics = train.fit(state, step, batches(),
                                       telemetry=tele)
            loss = float(metrics["loss"])
        report(loss, extra={"accuracy": float(metrics["accuracy"])})
    finally:
        if exporter is not None:
            exporter.stop()
    return loss


if __name__ == "__main__":
    # TRIAL_STEPS mirrors the sweep worker's TRIAL_SWEEP_STEPS: the
    # trial template sizes the workload without a custom command
    run_mnist_trial(steps=int(os.environ.get("TRIAL_STEPS", "30")))
