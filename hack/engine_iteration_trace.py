"""Where the generation engine's thread spends a traced run of the
benchmark's ``mistral-7b.docqa`` cell, and what the card's idle gaps
fall in, by the program's own spans.

Runs the cell as ``python3 -m portbench.run --trace 1`` does (the same
runner, stretches and readers), and besides:

- reads the engine's and the async loop's flight recorders right after
  each traced stretch stops (``read_rings``), and names every idle gap
  of the read stretch by the engine thread's innermost span
  (`` + http.loop`` where a loop pass covers it too), the client's label
  where no engine span covers it (``label_at``);
- the share of decode steps whose argmax ``Memcpy DtoH`` ends inside
  its ``engine.decode.sync`` span or within 0.5 ms after it (do the
  two clocks agree), and last, alone, the profiler's stamp of a copy's
  end against the host's ``time.time()`` at its return
  (``clock_probe``);
- the engine's parts' share of its thread's wall time over the window
  (``admit``, ``prefill``, ``import``, ``decode_prepare`` / ``launch``
  / ``sync`` / ``emit``, ``idle_wait``), and the async loop's busy share
  over the window less the traced stretches (``/metrics``'
  ``serving_async_loop_busy_seconds_total``).

Prints one JSON line a seed and writes each to
``build/engine_iteration/<seed>.json``::

    python3 hack/engine_iteration_trace.py --seeds 2147489001,2147489002
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = "mistral-7b.docqa"
#: the engine's parts of its thread's wall time (``stats`` keys)
PARTS = ("admit", "prefill", "import", "decode_prepare", "decode_launch",
         "decode_sync", "decode_emit", "idle_wait")
#: how long after its ``engine.decode.sync`` span a step's copy may end
CLOCK_SLACK_S = 0.5e-3


def coverage(s0, s1):
    """Each part's share of the engine thread's wall time between two
    marks, and their sum."""
    wall = s1["t"] - s0["t"]
    out = {p: (s1[f"{p}_seconds_total"] - s0[f"{p}_seconds_total"]) / wall
           for p in PARTS}
    out["sum"] = sum(out.values())
    out["wall_s"] = wall
    return out


def loop_busy_pct(run):
    from portbench.counters import untraced_growth
    busy, wall = untraced_growth(run, "loop_busy_seconds_total", "t")
    return 100.0 * busy / wall


def read_rings(served, cap):
    """The engine's and the loop's spans that overlap the stretch of
    ``cap`` (a stopped ``portbench.trace.Capture``) → ``(engine,
    loop)``, each empty where the program keeps no such ring. Both rings
    hold ``(name, start, end, attrs)`` tuples on the wall clock, and
    keep their latest spans only, so a run reads them right after each
    stretch stops; ``cap.offset_ns`` (wall less monotonic) puts them on
    the monotonic clock of its trace."""
    off = cap.offset_ns * 1e-9
    recorders = getattr(served.server, "recorders", None)
    rings = recorders(served.name) if recorders is not None else []
    got = [r.records(cap.t0 + off, cap.t1 + off) for r in rings]
    got += [[]] * (2 - len(got))
    return tuple(got)


def label_at(engine, loop, offset_ns, fallback):
    """→ ``label(monotonic seconds)``: the innermost engine span that
    covers the moment (the latest to start), with ``" + http.loop"``
    where a loop pass covers it too; ``fallback(t)`` where no engine
    span does."""
    off = offset_ns * 1e-9

    def label(t):
        w = t + off
        inner = max((s for s in engine if s[1] <= w < s[2]),
                    key=lambda s: (s[1], -s[2]), default=None)
        if inner is None:
            return fallback(t)
        if any(s[1] <= w < s[2] for s in loop):
            return inner[0] + " + http.loop"
        return inner[0]
    return label


def _quartiles(values):
    v = sorted(values)
    return [v[int(q * (len(v) - 1))] for q in (0, 0.25, 0.5, 0.75, 1)] \
        if v else None


def clocks_agree(trace, engine, offset_ns):
    """Do the profiler's device stamps and ``time.time()`` agree in the
    stretch? Of the ``engine.decode.sync`` spans wholly inside it: the
    share with a ``Memcpy DtoH`` that ends in the span or within
    ``CLOCK_SLACK_S`` after it; the quartiles of the nearest copy's end
    less the span's end (ms); the line ``lag = a + b · (t - t0)`` fitted
    to those lags (a in ms, b in ms a second), the quartiles of what it
    leaves, and the share once the device stamps are moved by it."""
    off = offset_ns * 1e-9
    ends = sorted(s + d for n, s, d in trace.ops
                  if n.startswith("Memcpy DtoH"))
    spans = [(a - off, b - off) for name, a, b, _ in engine
             if name == "engine.decode.sync"
             and trace.t0 <= a - off and b - off <= trace.t1]
    out = {"steps": len(spans), "copies": len(ends)}
    if not spans or not ends:
        return out

    def share(shift):
        return sum(any(a <= e - shift(e) <= b + CLOCK_SLACK_S
                       for e in ends) for a, b in spans) / len(spans)

    pts = [(b - trace.t0, min((e - b for e in ends), key=abs))
           for a, b in spans]
    n = len(pts)
    mx, my = sum(x for x, _ in pts) / n, sum(y for _, y in pts) / n
    sxx = sum((x - mx) ** 2 for x, _ in pts)
    slope = sum((x - mx) * (y - my) for x, y in pts) / sxx if sxx else 0.0
    icpt = my - slope * mx
    out.update({
        "share": share(lambda e: 0.0),
        "lag_ms": _quartiles([y * 1e3 for _, y in pts]),
        "fit_ms": icpt * 1e3, "fit_ms_per_s": slope * 1e3,
        "residual_ms": _quartiles([(y - icpt - slope * x) * 1e3
                                   for x, y in pts]),
        "share_fitted": share(
            lambda e: icpt + slope * (e - trace.t0))})
    return out


def clock_probe(seconds=20.0):
    """The profiler's clock for device events against ``time.time()``,
    on the card: one session in which a ~1 ms kernel and then a copy to
    the host run every 10 ms; for each, the copy's end as the profiler
    stamps it less the host's return from ``.cpu()``, in ms (a few
    hundredths below 0 where the clocks agree) → ``{"lags_ms": quartiles,
    "first_ms", "last_ms": the first and last fifth's medians, "n"}``."""
    import torch
    x = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    returns = []
    t_end = time.time() + seconds
    while time.time() < t_end:
        torch.cuda._sleep(2_000_000)
        x.cpu()
        returns.append(time.time())
        time.sleep(0.01)
    torch.cuda.synchronize()
    prof.stop()
    ends = sorted((e.start_ns() + e.duration_ns()) * 1e-9
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("Memcpy DtoH"))
    lags = [min((e - r for e in ends), key=abs) * 1e3 for r in returns] \
        if ends else []
    fifth = max(len(lags) // 5, 1)
    return {"n": len(lags), "copies": len(ends),
            "lags_ms": _quartiles(lags),
            "first_ms": _quartiles(lags[:fifth])[2] if lags else None,
            "last_ms": _quartiles(lags[-fifth:])[2] if lags else None}


def one(bench, seed, seconds, device, **overrides):
    """One traced run of the cell → its readings (a dict)."""
    from kubeflow_tpu_torch.compute import serving_async
    from portbench import harness
    from portbench import trace as pb_trace
    from portbench.runners import serve_generate as sg
    held = {"rings": []}

    class Served(sg.Served):
        def __init__(self, ctx):
            super().__init__(ctx)
            held["served"] = self

        def stats(self):
            return {**self.engine.stats, "t": time.monotonic(),
                    "loop_busy_seconds_total":
                        serving_async._LOOP_BUSY.value()}

    class Capture(pb_trace.Capture):
        def stop(self):
            super().stop()
            # how far the wall clock moved against the monotonic one
            # through the session
            self.wall_moved_ms = (time.time_ns() - time.monotonic_ns()
                                  - self.offset_ns) * 1e-6
            held["rings"].append(
                (self, read_rings(held["served"], self)))

    ctx = harness.context(bench, CELL, seed, seconds, True, device,
                          time.monotonic(), **overrides)
    plain = sg.Served, sg.Capture
    sg.Served, sg.Capture = Served, Capture
    try:
        run = sg.run(ctx)
    finally:
        sg.Served, sg.Capture = plain
    dev = harness.device_info(device, 1)
    metrics = {}
    for m in harness._for_cell(bench["per_layer"], CELL):
        metrics[m["name"]] = harness.reader(m["name"])(run, dev)
    metrics["http_loop_busy_pct.serve"] = loop_busy_pct(run)
    out = {"seed": seed, "device": dev, "e2e": run.e2e,
           "correct": all(harness._passes(v, lim)
                          for v, lim in run.checks.values()),
           "metrics": metrics,
           "coverage": coverage(*run.data["stats"])}
    tr = run.trace
    if tr is None:
        return out
    cap, (engine, loop) = next((c, r) for c, r in held["rings"]
                               if c.t0 == tr.t0)
    named = label_at(engine, loop, cap.offset_ns, run.label_at)
    busy, gaps = tr.busy()
    by_label = {}
    for s, d in gaps:
        key = named(s + d / 2)
        by_label[key] = by_label.get(key, 0.0) + d
    top = sorted(gaps, key=lambda g: -g[1])[:pb_trace.TOP]
    clocks = clocks_agree(tr, engine, cap.offset_ns)
    if "fit_ms" in clocks:
        # the engine's spans moved onto the profiler's stamps by the line
        # fitted to the decode steps' copies
        off = cap.offset_ns * 1e-9

        def moved(ring):
            def err(w):
                return (clocks["fit_ms"] + clocks["fit_ms_per_s"]
                        * (w - off - tr.t0)) * 1e-3
            return [(n, a + err(a), b + err(b), at) for n, a, b, at in ring]
        fitted = label_at(moved(engine), moved(loop), cap.offset_ns,
                                run.label_at)
        out["idle_gaps_fitted"] = [[fitted(s + d / 2), d] for s, d in top]
    out.update({
        "stretch_s": tr.window_s, "busy_s": busy,
        "idle_gaps": [[named(s + d / 2), run.label_at(s + d / 2), d]
                      for s, d in top],
        "idle_s_by_label": dict(sorted(by_label.items(),
                                       key=lambda kv: -kv[1])),
        "clocks": dict(clocks, wall_moved_ms=cap.wall_moved_ms)})
    return out


def main(argv):
    p = argparse.ArgumentParser(prog="hack/engine_iteration_trace.py")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=int, default=51)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as pb_run
    pb_run.pin_caches(ROOT)
    from portbench import harness
    harness.pin_cpus()
    harness.prebuild_kernels()
    bench = harness.load_benchmark()
    out_dir = ROOT / "build" / "engine_iteration"
    out_dir.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = one(bench, seed, args.seconds, "cuda")
        (out_dir / f"{seed}.json").write_text(json.dumps(got, indent=1))
        print(json.dumps(got), flush=True)
    probe = clock_probe()
    (out_dir / "clock_probe.json").write_text(json.dumps(probe))
    print(json.dumps({"clock_probe": probe}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
