"""Readings that set a cell's limits: the program's compared numbers on
many seeds (the lower readings), and the control's and the planted
faults' (the upper readings), at the cell's own size::

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 12]

One JSON line a seed and reading. The benchmark's own runs never run
this.

- Serving: the program serves the cell's traffic for a short window
  under the cell's load; over the run's sample the reference gives the
  served tokens' widest gap (``program``) and, on control seeds, the
  gap of the token that the reference in float8 puts first at each of
  the same positions (``control``).
- Training: the program's first three steps against the reference's
  (``program``); on control seeds, the reference in float8 put in the
  program's place (``control``) and the reference with half of each
  batch left out, the mean taken over the rest (``half_batch``). A
  state left unchanged reads 1 in ``change_norm_gap`` by definition.
"""

import argparse
import json
import sys

from . import harness
from .run import pin_caches


def _emit(obj):
    print(json.dumps(obj), flush=True)


def serve(ctx, control):
    from .runners import common
    from .runners import serve_generate as sg
    served = sg.Served(ctx)
    try:
        res = sg.measure(ctx, served, ctx.settings.get("rate"), ctx.seed,
                         ctx.seconds)
    finally:
        served.stop()
    params = served.params
    del served
    common.release(ctx.device)
    precisions = ("fp32", "fp8") if control else ("fp32",)
    got = sg.check(ctx, params, res["records"], ctx.settings.get("rate"),
                   ctx.seconds, precisions)
    _, _, unfinished = sg.latencies(res["records"], res["w1"],
                                    float(ctx.settings["wait_s"]))
    _emit({"seed": ctx.seed, "reading": "program",
           "widest_gap": got["fp32"], "unfinished": unfinished,
           "sampled_tokens": got["sampled_tokens"]})
    if control:
        _emit({"seed": ctx.seed, "reading": "control",
               "widest_gap": got["fp8"]})


def train(ctx, control):
    from . import compare
    from .reference import train as ref_train
    from .runners import common
    from .runners import train_lm as tl
    from .traffic import generator
    s = ctx.settings
    rows = generator(ctx.mix["kind"]).packed_rows(
        ctx.mix, ctx.seed, 3, ctx.config["vocab_size"], ctx.device)

    def batch(i):
        return {"tokens": rows[i, :, :-1], "targets": rows[i, :, 1:]}

    state, step = tl.program(ctx)
    state, prog = tl.first_steps(ctx, state, step, batch)
    del state, step
    common.release(ctx.device)
    args = (ctx.config, ctx.seed, list(rows), tl.reference_optimizer(s),
            ctx.device)
    block = int(s["reference_block"])
    ref = ref_train.follow(*args, block=block)
    readings = [("program", prog)]
    if control:
        readings += [("control", ref_train.follow(*args, precision="fp8",
                                                  block=block)),
                     ("half_batch", ref_train.follow(*args, half_batch=True,
                                                     block=block))]
    for name, got in readings:
        numbers, worst = compare.train_numbers(got, ref)
        _emit({"seed": ctx.seed, "reading": name, **numbers,
               "worst_leaves": {k: "/".join(v) for k, v in worst.items()},
               "loss": got["loss"], "reference_loss": ref["loss"]})
        common.release(ctx.device)


def readings(bench, workload, seeds, control_seeds, seconds,
             device="cuda", config=None, settings=None, mix=None):
    """Emit every seed's readings (``config``, ``settings`` and ``mix``
    replace the files', as in ``harness.run_cell``)."""
    for seed in seeds:
        ctx = harness.context(bench, workload, seed, seconds, device=device,
                              config=config, settings=settings, mix=mix)
        kind = ctx.settings["runner"]
        (serve if kind == "serve_generate" else train)(
            ctx, seed in control_seeds)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=int, default=12)
    args = p.parse_args(argv)
    readings(harness.load_benchmark(), args.workload,
             [int(x) for x in args.seeds.split(",")],
             {int(x) for x in args.control_seeds.split(",") if x},
             args.seconds)
    return 0


if __name__ == "__main__":
    pin_caches()
    sys.exit(main())
