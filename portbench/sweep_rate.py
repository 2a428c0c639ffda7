"""The knee of a serving cell: the highest offered rate the program
sustains, found once by a sweep on the chip::

    python3 -m portbench.sweep_rate --workload mistral-7b.docqa \
        --rates 5,5.5,6,6.5,7 --seed 1 --seconds 51

One process serves the cell's traffic at each rate in turn (the same
weights and server, the client's warm-up pass and lead-in before each
window) and prints one JSON line a rate: the offered rate, the rate of
completions inside the window, the engine's queue at the window's
start and end, and TTFT and gap percentiles. The knee is the highest
rate whose completions keep up with the offer and whose queue does not
grow over the window. A cell below it runs at a fixed rate written in
its file; a cell above it at the mix's closed loop, which keeps the
engine's slots full."""

import argparse
import json
import sys

from . import harness
from .run import pin_caches


def sweep(ctx, rates):
    from .runners import common
    from .runners import serve_generate as sg
    served = sg.Served(ctx)
    try:
        for rate in rates:
            res = sg.measure(ctx, served, rate, ctx.seed, ctx.seconds)
            recs = res["records"]
            w0, w1 = res["w0"], res["w1"]
            window = [r for r in recs if r["phase"] == "window"]
            done_in = sum(1 for r in recs if sg.finished(r)
                          and w0 <= r["times"][-1] < w1)
            ttft, gaps, unfinished = sg.latencies(
                recs, w1, float(ctx.settings["wait_s"]))
            print(json.dumps({
                "rate": rate, "offered_per_s": len(window) / ctx.seconds,
                "completed_per_s": done_in / ctx.seconds,
                "queued_start": res["queued0"], "queued_end": res["queued1"],
                "unfinished": unfinished,
                "ttft_p50_ms": common.percentile(ttft, 50) * 1e3,
                "ttft_p95_ms": common.percentile(ttft, 95) * 1e3,
                "itg_p50_ms": common.percentile(gaps, 50) * 1e3,
                "itg_p95_ms": common.percentile(gaps, 95) * 1e3,
                "decode_steps": res["stats1"]["decode_steps"]
                - res["stats0"]["decode_steps"]}), flush=True)
    finally:
        served.stop()


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep_rate")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=int, default=51)
    args = p.parse_args(argv)
    ctx = harness.context(harness.load_benchmark(), args.workload,
                          args.seed, args.seconds)
    sweep(ctx, [float(r) for r in args.rates.split(",")])
    return 0


if __name__ == "__main__":
    pin_caches()
    sys.exit(main())
