"""A served cell of the benchmark run as its runner runs it, with the
readings a cell's line does not carry: the reference's gap of the served
tokens and the float8 control's, which set a cell's ``widest_gap``
limit (and, where the runner has its own comparison, as
``serve_afmoe``'s ``off_top_share``, that comparison's verdict on the
program's and each control's tokens), and the engine's counters over
the window.

    python3 hack/serve_cell_probe.py --cell trinity-mini.docqa-long \
        --seeds 2147493001 [--seconds 51] [--control fp8[,bf16ops]] \
        [--layers N] [--dtype float32] [--fault window_ignored] \
        [--dump chiprun_out/gaps.jsonl]

For each seed, in one process: the cell's runner brings the program up
(``Served``), the mix runs for the window (``serve_generate.measure``,
untraced), the program goes down, and the runner's ``check`` compares
the sample with the plain float32 reference (and, with ``--control``,
the reference in each of those precisions: ``fp8``, the float8
control, or ``bf16ops``, the reference with every linear product's
operands rounded to bfloat16, as a bf16 program rounds them). One JSON
line a seed: the card and its power limit, ``gen_tokens_per_s``,
``setup_s``, the peak of allocated device bytes, the gaps (each
request's first token, from its prefill, and its widest over the decode
steps after it; the widest of all, the mean and 90th percentile over
every compared token, and the share of tokens off the reference's
argmax; with ``--dump``, every compared token's gap and rank among
the reference's logits, a line a seed), and the growth over the
window of the engine's counters (decode steps and seconds, prefills,
prefix hits and skipped tokens, and an expert model's ``moe_*``). For a
diagnosis, ``--layers`` cuts the model to its first N layers (an AFMoE
configuration's ``layer_types`` with it) and ``--dtype`` sets the
program's dtype; ``--fault`` plants ``window_ignored`` or
``bias_in_weights`` in the program, not the reference. One seed a process: the weights are freed only with
it. Needs a CUDA device.
"""

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run as bench_run  # noqa: E402

KEYS = ("decode_steps", "decode_seconds_total", "decode_token_slots",
        "prefills", "prefix_hits", "prefix_tokens_skipped",
        "decode_graph_replays", "moe_calls", "moe_assignments_total",
        "moe_padded_rows_total", "moe_active_experts_total")


def _bf16ops(mm):
    """``mm`` with a ``"bf16ops"`` precision: both operands rounded to
    bfloat16, the product in float32."""
    def wrapped(a, b, precision):
        if precision == "bf16ops":
            return a.bfloat16().float() @ b.bfloat16().float()
        return mm(a, b, precision)
    return wrapped


def _gaps(ctx, runner, params, records, seconds, precisions):
    """The runner's check (its sample, its reference) with each
    request's gaps apart: ``{precision: [[first token's, widest after
    it], ...]}`` and the widest of each."""
    import torch
    from portbench import compare
    from portbench.reference import afmoe as ref_afmoe
    from portbench.reference import model as ref_model
    from portbench.traffic import generator
    from portbench.runners import serve_generate
    picked = serve_generate._sample(records, ctx.seed, ctx.settings["check"])
    if not picked:
        return None
    prompts = generator(ctx.mix["kind"]).prompts(
        ctx.mix, ctx.seed, ctx.config["vocab_size"],
        [r["id"] for r in picked], None, seconds)
    seqs, positions, served = [], [], []
    for r in picked:
        toks = torch.tensor(r["tokens"], dtype=torch.long, device=ctx.device)
        p = torch.as_tensor(prompts[r["id"]], device=ctx.device)
        seqs.append(torch.cat([p, toks[:-1]]))
        positions.append(torch.arange(len(p) - 1, len(p) - 1 + len(toks),
                                      device=ctx.device))
        served.append(toks)
    afmoe = "num_experts" in ctx.config
    mod = ref_afmoe if afmoe else ref_model
    saved = mod.mm
    mod.mm = _bf16ops(saved)
    try:
        with ref_model.fp32_matmuls():
            m = (ref_afmoe.Model if afmoe else ref_model.Model).of(ctx.config)
            logits = mod.served_logits(params, seqs, positions, m,
                                       precisions)
    finally:
        mod.mm = saved
    out = {"requests": [[r["prompt_len"], len(r["tokens"])] for r in picked]}
    for p in precisions:
        per = []
        for ref, low, t in zip(logits["fp32"], logits[p], served):
            toks = t if p == "fp32" else torch.argmax(low, dim=-1)
            per.append([compare.served_gap(ref[:1], toks[:1]),
                        compare.served_gap(ref[1:], toks[1:])
                        if len(toks) > 1 else 0.0])
        out[p] = per
        out[p + "_widest"] = max(max(g) for g in per)
        every = torch.cat([
            ref.max(-1).values - ref.gather(-1, (
                t if p == "fp32" else torch.argmax(low, dim=-1))[:, None])[:, 0]
            for ref, low, t in zip(logits["fp32"], logits[p], served)])
        out[p + "_mean"] = float(every.mean())
        out[p + "_p90"] = float(torch.quantile(every, 0.9))
        out[p + "_off_argmax"] = float((every > 0).float().mean())
        if hasattr(runner, "comparison"):
            # the runner's own reading and comparison of these tokens
            from portbench.harness import _passes
            off = torch.cat([runner.reading(
                ref, t, int(ctx.settings["check"]["top"]))[0]
                for ref, t in zip(logits["fp32"], [
                    (t if p == "fp32" else torch.argmax(low, dim=-1))
                    for low, t in zip(logits[p], served)])])
            checks = runner.comparison(
                {"off_top_share": float(off.float().mean())},
                ctx.settings["limits"])
            out[p + "_runner_check"] = {
                k: {"value": v, "limit": lim, "passes": _passes(v, lim)}
                for k, (v, lim) in checks.items()}
        # each request's every token: its gap and its rank among the
        # reference's logits (0: the reference's best)
        tokens = [(t if p == "fp32" else torch.argmax(low, dim=-1))
                  for low, t in zip(logits[p], served)]
        out[p + "_tokens"] = [
            [[round(float(g), 5) for g in
              ref.max(-1).values - ref.gather(-1, t[:, None])[:, 0]],
             (ref > ref.gather(-1, t[:, None])).sum(-1).tolist()]
            for ref, t in zip(logits["fp32"], tokens)]
    return out


def _plant(fault):
    """A fault planted in the program (not the reference), as the CPU
    tests plant it: ``window_ignored`` (every layer full causal, RoPE
    where it was) or ``bias_in_weights`` (the router's selection bias
    in the expert weights too)."""
    import torch
    from kubeflow_tpu_torch.compute.models import transformer as tt
    if fault == "window_ignored":
        tt.PortConfig.layer_window = lambda s, i: 0
        return
    if fault == "bias_in_weights":
        real = tt._sigmoid_router

        def biased(logits, lp, config, k):
            scores, _, idx = real(logits, lp, config, k)
            g = torch.gather(scores + lp["router_bias"].float(), -1, idx)
            return scores, g / g.sum(-1, keepdim=True) \
                * config.moe_route_scale, idx
        tt._sigmoid_router = biased
        return
    raise ValueError(f"unknown fault {fault!r}")


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=int, default=51)
    p.add_argument("--control", default="")
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--dtype", default=None)
    p.add_argument("--fault", default="")
    p.add_argument("--dump", default="")
    a = p.parse_args(argv)
    if a.fault:
        _plant(a.fault)
    bench_run.pin_caches()
    from portbench import harness
    harness.pin_cpus()
    harness.prebuild_kernels()
    import torch
    from portbench.runners import common, serve_generate
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    bench = harness.load_benchmark()
    for seed in (int(s) for s in a.seeds.split(",")):
        t_start = time.monotonic()
        ctx = harness.context(bench, a.cell, seed, a.seconds,
                              t_start=t_start)
        if a.layers:
            ctx.config["num_hidden_layers"] = a.layers
            if "layer_types" in ctx.config:
                ctx.config["layer_types"] = ctx.config["layer_types"][
                    :a.layers]
        if a.dtype:
            ctx.settings["program"] = dict(ctx.settings.get("program", {}),
                                           dtype=a.dtype)
        runner = importlib.import_module(
            f"portbench.runners.{ctx.settings['runner']}")
        torch.cuda.reset_peak_memory_stats()
        served = runner.Served(ctx)
        try:
            res = serve_generate.measure(ctx, served, None, seed,
                                         a.seconds)
        finally:
            served.stop()
        peak = common.memory_peak("cuda")
        params = served.params
        del served
        common.release("cuda")
        w0, w1 = res["w0"], res["w1"]
        precisions = ("fp32",) + tuple(c for c in a.control.split(",") if c)
        t0 = time.monotonic()
        got = _gaps(ctx, runner, params, res["records"], a.seconds,
                    precisions)
        s0, s1 = res["stats0"], res["stats1"]
        if a.dump:
            with open(a.dump, "a") as f:
                f.write(json.dumps({"seed": seed, "fault": a.fault,
                                    **{k: v for k, v in got.items()
                                       if k.endswith("_tokens")
                                       or k == "requests"}}) + "\n")
            got = {k: v for k, v in got.items()
                   if not k.endswith("_tokens")}
        print(json.dumps({
            "fault": a.fault,
            "cell": a.cell, "seed": seed, "card": card.strip(),
            "gen_tokens_per_s": sum(w0 <= t < w1 for r in res["records"]
                                    for t in r["times"]) / (w1 - w0),
            "setup_s": w0 - t_start, "memory_peak_bytes": peak,
            "check": got, "check_s": time.monotonic() - t0,
            "growth": {k: s1[k] - s0[k] for k in KEYS if k in s0}}),
            flush=True)
        del params
        common.release("cuda")


if __name__ == "__main__":
    main(sys.argv[1:])
