"""One run of one cell: find its files by name, run its runner, read its
per-layer metrics, decide ``correct`` and print the result line.

``run_cell`` does all of it on the device it is given, so a test can
drive a tiny cell on the CPU; :func:`main` is the command's entry, which
first requires the cards the cell asks for and last requires that no
JAX module was loaded."""

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "kubeflow_tpu")


@dataclasses.dataclass
class Run:
    """What a runner hands back."""
    e2e: dict
    attempted: int
    failed: int
    checks: dict                 # name → (value, limit)
    memory_peak_bytes: int
    trace: object = None         # trace.Trace of the traced stretch
    label_at: object = None      # monotonic seconds → what the host did
    data: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    """What a runner is given."""
    cell: str
    config: dict
    mix: dict
    settings: dict
    seed: int
    seconds: int
    trace: bool
    device: str
    t_start: float
    root: Path = ROOT

    def note(self, line):
        """A line for the run's standard error (before the checks)."""
        print(line, file=sys.stderr, flush=True)


def load_benchmark(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _read_json(path):
    return json.loads(Path(path).read_text())


def _for_cell(metrics, cell):
    """The metrics of ``metrics`` this cell reports: those that list it
    under ``workloads``, and those without the key (a per-layer reader
    that finds nothing to read in a cell returns nothing)."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def reader(name):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(device, count):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev), "count": count}
    return {"platform": dev.type, "kind": dev.type, "count": count}


def context(bench, name, seed, seconds, trace=False, device="cuda",
            t_start=None, config=None, settings=None, mix=None):
    """The :class:`Context` of cell ``name``, its files found by the
    names ``BENCHMARK.json`` gives; ``config``, ``settings`` and ``mix``
    replace the files' (the tests' tiny cells)."""
    entry = cell_entry(bench, name)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Context(
        cell=name,
        config=config or _read_json(ROOT / conf["file"]),
        mix=mix or _read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        settings=settings or _read_json(HERE / "workloads" / f"{name}.json"),
        seed=int(seed), seconds=int(seconds), trace=bool(trace),
        device=device,
        t_start=time.monotonic() if t_start is None else t_start)


def run_cell(bench, name, seed, seconds, trace, device="cuda",
             t_start=None, config=None, settings=None, mix=None):
    """Run cell ``name`` once → the result dict (the printed line's
    object)."""
    entry = cell_entry(bench, name)
    ctx = context(bench, name, seed, seconds, trace, device, t_start,
                  config, settings, mix)
    runner = importlib.import_module(
        f"portbench.runners.{ctx.settings['runner']}")
    run = runner.run(ctx)
    dev = device_info(device, entry["chips"])
    dev["memory_peak_bytes"] = run.memory_peak_bytes
    e2e = _for_cell(bench["end_to_end"], name)
    result = {"correct": all(_passes(v, lim)
                             for v, lim in run.checks.values()),
              "attempted": run.attempted, "failed": run.failed}
    if not trace:
        result["metrics"] = {m["name"]: {"value": run.e2e[m["name"]],
                                         "unit": m["unit"]} for m in e2e}
    else:
        metrics = {}
        for m in _for_cell(bench["per_layer"], name):
            value = reader(m["name"])(run, dev)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if run.trace is not None:
            busy, _ = run.trace.busy()
            dev["busy_s"] = busy
            dev["window_s"] = run.trace.window_s
    result["device"] = dev
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown(run.label_at)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    return result


def _passes(value, limit):
    """A number passes its limit; one without a number or a limit
    does not."""
    return (value is not None and limit is not None
            and not math.isnan(value) and value <= limit)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


#: CPUs that a run holds its own threads to, and the one its client
#: child (``portbench.client``) gets beside them
RUN_CPUS = 3
CLIENT_CPU_ENV = "PORTBENCH_CLIENT_CPU"


def pin_cpus():
    """Hold this process, before it starts a thread, to the first
    ``RUN_CPUS`` CPUs it may use, and name the next for its client (in
    the environment its children inherit). Where the threads of the
    program (its engine loop, the HTTP loop) and the client land among
    all of a host's CPUs changes from process to process, and with it
    the host's pace of a decode step; on fewer CPUs than that it does
    nothing."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) > RUN_CPUS:
        os.sched_setaffinity(0, cpus[:RUN_CPUS])
        os.environ[CLIENT_CPU_ENV] = str(cpus[RUN_CPUS])


def main(argv, t_start):
    args = parse(argv)
    bench = load_benchmark()
    chips = cell_entry(bench, args.workload)["chips"]
    pin_cpus()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    prebuild_kernels()
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      args.trace, device="cuda", t_start=t_start)
    return finish(result)


def prebuild_kernels():
    """Build the port's stale CUDA libraries in a child process, before
    this one touches the card (set-up; nothing to do once a checkout has
    built them). A library built at its first use inside the measuring
    process left that process's window about 30 % slower on an H100:
    339.49 tokens/s in a fresh checkout's first run, 433.80–457.20 in the
    runs after it, 547.51 in a first run whose libraries a child had
    built."""
    try:
        from kubeflow_tpu_torch.compute.ops import _build
        stale = [n for n in _build.SOURCES
                 if not _build._target(n)[1].exists()]
    except (ImportError, AttributeError):
        return
    if stale:
        subprocess.run([sys.executable, "-c",
                        "from kubeflow_tpu_torch.compute.ops import _build;"
                        " _build.build()"], cwd=str(ROOT), check=True)


def finish(result, out=None, err=None):
    """Print the result (last line of standard output) and the compared
    numbers beside their limits (last lines of standard error) → the
    exit code; none printed, and 3, if a JAX module was loaded."""
    out, err = out or sys.stdout, err or sys.stderr
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: JAX modules were loaded in this process: {bad}",
              file=err, flush=True)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
