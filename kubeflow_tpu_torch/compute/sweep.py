"""Vectorized HPO sweeps — many trials as ONE batched computation.

Port of ``kubeflow_tpu/compute/sweep.py``. The sequential StudyJob path
runs one tiny trial at a time and idles the card between trials; this
engine stacks a whole sweep into batched tensors instead:

- **Bucketing**: trials are grouped by the hyperparameters that change
  tensor *shapes* (``hidden`` & friends — anything not in
  ``CONTINUOUS_KEYS``). Trials that differ only in continuous knobs
  (``lr``, ``weight_decay``, ``clip_norm``) share one bucket.
- **Vectorized optimizer**: the continuous knobs become per-trial
  *tensor elements*; ``train.make_optimizer`` is built per trial under
  ``torch.func.vmap`` with 0-d tensors (its schedule only multiplies by
  the peak), so K optimizers run as one batched update
  (``AdamW.update_fn``).
- **One batched step per bucket**: params and optimizer moments carry a
  leading trial axis; each step is ``vmap`` over ``(hp, params, mu,
  nu)`` of ``torch.func.grad`` of the MLP loss, in a Python loop over
  the steps (JAX rolls the steps into a ``lax.scan`` inside one compiled
  program; eager PyTorch has no program to roll them into). On one
  device the trial axis needs no padding; ``_pad_members`` and the
  occupancy histogram stay for the multi-device slice.
- **No compile cache**: eager PyTorch compiles no program, so there is
  no cache to hit. ``sweep_compile_cache_total{result}`` stays
  registered (the metrics lint names it) and counts nothing;
  ``install_cache_listener`` is a no-op.

Per-trial objectives fan back out through the EXISTING trial contract:
one parseable ``trial-metric`` stdout line per trial (``trial.report``
with its index), so the StudyJob metrics collector and medianstop
parsing are untouched.

Worker entry: ``python -m kubeflow_tpu_torch.compute.sweep`` with
``TRIAL_SWEEP_PARAMETERS`` holding the JSON trial list (the env the
StudyJobReconciler injects into a packed sweep pod). As in JAX, the
worker runs the shard exporter (``obs/export.py``) and one
``sweep-worker`` span (``obs/tracing.py``) on the study's trace.
"""

import json
import os
import time

from ..obs import metrics as obs_metrics

#: hyperparameters that stay *continuous* under vectorization — they
#: become per-trial tensors inside one batched step. Everything else
#: changes shapes and defines the bucket key.
CONTINUOUS_KEYS = ("lr", "weight_decay", "clip_norm")

#: trials packed into one vectorized program (one histogram sample per
#: bucket run)
TRIALS_PER_PROGRAM = obs_metrics.REGISTRY.histogram(
    "sweep_trials_per_program",
    "Trials packed into one vectorized sweep program",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))

#: live-trial fraction of the padded trial axis (1.0 = no padding; the
#: axis pads up to a multiple of the trial-shard size, 1 on one device)
BUCKET_OCCUPANCY = obs_metrics.REGISTRY.histogram(
    "sweep_bucket_occupancy_ratio",
    "Live-trial fraction of the padded vectorized trial axis",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))

#: registered for the fleet's dashboards and the metrics lint; eager
#: PyTorch compiles no program, so nothing ever counts here
COMPILE_CACHE = obs_metrics.REGISTRY.counter(
    "sweep_compile_cache_total",
    "Persistent compile-cache hits/misses observed in-process",
    ("result",))


def install_cache_listener():
    """No-op: there is no compilation cache to listen to (eager
    PyTorch). Kept so a worker written against the JAX module runs."""


# ------------------------------------------------------------- bucketing

def bucket_key(params, continuous=CONTINUOUS_KEYS):
    """The shape signature of one trial's hyperparameters: everything
    that is not a continuous knob, as a sorted, hashable tuple."""
    return tuple(sorted(
        (k, v) for k, v in params.items() if k not in continuous))


def bucket_trials(trials, continuous=CONTINUOUS_KEYS):
    """Group ``[(index, params), ...]`` into shape buckets.

    Returns ``[(key, members)]`` with ``members`` preserving input
    order — trials in one bucket run as ONE vmapped step; two trials
    with different shape signatures are never mixed.
    """
    buckets = {}
    for index, params in trials:
        buckets.setdefault(
            bucket_key(params, continuous), []).append((index, params))
    # repr-keyed sort: deterministic bucket order even when two keys
    # mix value types (("hidden", 64) vs ("hidden", "a") won't compare)
    return sorted(buckets.items(), key=lambda kv: repr(kv[0]))


# ------------------------------------------------- vectorized execution

def _pad_members(members, multiple):
    """Pad a bucket to a multiple of the trial-shard size by repeating
    the last member (its result is computed and dropped)."""
    if multiple <= 1 or len(members) % multiple == 0:
        return list(members)
    pad = multiple - len(members) % multiple
    return list(members) + [members[-1]] * pad


def _hp_arrays(members, defaults, device):
    """Continuous hyperparams as stacked per-trial fp32 tensors."""
    import torch
    return {key: torch.tensor([float(p.get(key, default))
                               for _, p in members],
                              dtype=torch.float32, device=device)
            for key, default in defaults.items()}


def run_mnist_sweep(trial_params, steps=30, device=None, trial_shard=1):
    """Run K mnist trials (the default StudyJob objective) vectorized.

    ``trial_params`` is a list of hyperparameter dicts (or
    ``(index, dict)`` pairs). Returns one result dict per input trial,
    in input order: ``{"index", "objective", "metrics"}`` — each
    objective equal (within float tolerance) to what
    ``trial.run_mnist_trial`` computes for the same hyperparameters,
    because both run the identical model, init seed, batch and
    optimizer; the sweep merely batches them per shape bucket.
    ``device`` None → the card. ``trial_shard`` is the size the trial
    axis is padded to a multiple of (the mesh's data axis in JAX; 1 on
    one device).
    """
    import torch
    from torch.func import grad, vmap

    from . import device as device_lib
    from . import train
    from . import trial as trial_lib
    from .models import mlp

    dev = device_lib.resolve(device)
    normalized = []
    for i, entry in enumerate(trial_params):
        if isinstance(entry, tuple):
            index, params = entry
        else:
            index, params = i, entry
        normalized.append(
            (index, dict({"lr": 1e-2, "hidden": 64}, **(params or {}))))

    # the mnist objective's fixed data (identical to run_mnist_trial)
    batch = trial_lib.mnist_batch(dev)
    defaults = {k: trial_lib.MNIST_DEFAULTS[k] for k in CONTINUOUS_KEYS}

    results = {}
    for _, members in bucket_trials(normalized):
        padded = _pad_members(members, trial_shard)
        TRIALS_PER_PROGRAM.observe(len(members))
        BUCKET_OCCUPANCY.observe(len(members) / len(padded))
        k = len(padded)
        hidden = int(padded[0][1]["hidden"])
        cfg = mlp.Config(in_dim=784, hidden=hidden, n_classes=10)
        hps = _hp_arrays(padded, defaults, dev)

        def make_opt(hp):
            # the exact optimizer run_mnist_trial builds, with the
            # continuous knobs as 0-d tensors
            return train.make_optimizer(
                learning_rate=hp["lr"], warmup_steps=2,
                total_steps=steps, weight_decay=hp["weight_decay"],
                clip_norm=hp["clip_norm"])

        def per_trial(hp, params, mu, nu, count):
            grads, metrics = grad(
                lambda p: mlp.loss_fn(p, batch, cfg), has_aux=True)(params)
            params, opt_state, _ = make_opt(hp).update_fn(
                params, grads, {"count": count, "mu": mu, "nu": nu})
            return params, opt_state["mu"], opt_state["nu"], metrics

        # every trial starts from the same seed-0 weights, as a lone
        # trial does, stacked along the trial axis
        one = mlp.init_params(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        params = train.tree_map(
            lambda t: t.unsqueeze(0).repeat(k, *([1] * t.dim())), one)
        mu = train.tree_map(torch.zeros_like, params)
        nu = train.tree_map(torch.zeros_like, params)
        metrics = None
        with torch.no_grad():
            for count in range(steps):
                params, mu, nu, metrics = vmap(
                    lambda hp, p, m, n: per_trial(hp, p, m, n, count))(
                        hps, params, mu, nu)
        for j, (index, _) in enumerate(members):
            per = {name: float(vals[j]) for name, vals in metrics.items()}
            results[index] = {"index": index,
                              "objective": per["loss"],
                              "metrics": per}
    return [results[index] for index, _ in normalized]


# ----------------------------------------------------- report + worker

def report_sweep(results, name=None):
    """Fan per-trial objectives out through the single-trial contract:
    one ``trial-metric`` line per trial, each carrying its trial index
    (``trial.report`` — the collector parses name/value exactly as for
    a lone trial; the index routes the value to the right StudyJob
    trial record)."""
    from . import trial as trial_lib
    for r in results:
        extra = {k: v for k, v in r["metrics"].items() if k != "loss"}
        trial_lib.report(r["objective"], name=name, extra=extra or None,
                         trial=r["index"])


def trials_from_env():
    """Decode ``TRIAL_SWEEP_PARAMETERS``: a JSON list of
    ``{"index": i, "parameters": {...}}`` records (the packed-pod
    contract the StudyJobReconciler injects)."""
    blob = os.environ.get("TRIAL_SWEEP_PARAMETERS")
    if not blob:
        return []
    return [(int(t["index"]), dict(t.get("parameters") or {}))
            for t in json.loads(blob)]


def main(device=None):
    from ..obs import export as obs_export
    from ..obs import tracing
    from . import telemetry as telem

    exporter = obs_export.start_exporter()
    tele = telem.TrainTelemetry("sweep-mlp")
    install_cache_listener()
    trials = trials_from_env()
    if not trials:
        raise SystemExit(
            "sweep worker: TRIAL_SWEEP_PARAMETERS is empty — nothing "
            "to run")
    steps = int(os.environ.get("TRIAL_SWEEP_STEPS", "30"))
    try:
        # one span on the study's gang trace per packed pod. Goodput:
        # spawn → first dispatch is the start-up window; the sweep's
        # wall time (results read back, so the card has finished)
        # books as compute via observe_steps
        with tracing.span("sweep-worker",
                          traceparent=os.environ.get("TRACEPARENT"),
                          trials=len(trials), steps=steps):
            tele.step()
            t0 = time.perf_counter()
            results = run_mnist_sweep(trials, steps=steps, device=device)
            tele.observe_steps(steps, time.perf_counter() - t0)
        report_sweep(results)
    finally:
        if exporter is not None:
            exporter.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
