"""Runner ``serve_generate``: a language model served over HTTP.

The program under test is the port's ``ModelServer`` on the async
transport (one ``selectors`` loop), ``:generate`` streaming NDJSON,
in front of a ``GenerationEngine`` (paged KV pool, prefix cache,
continuous batching, monolithic prefill, greedy decoding), built with
the cell's ``engine`` settings as its keyword arguments. The weights
are drawn on the card from the seed in the served dtype. A client in a
child process (``portbench.client``) sends the traffic mix: the mix's
closed loop of callers, or an open loop at the cell's ``rate`` where
the cell gives one.

End to end, at the client: ``gen_tokens_per_s``, the token frames that
arrive inside the window over its seconds (every request's: what the
server completes); ``ttft_p95_ms`` (due time → first token frame; a
request that never finishes counts at the time the client gave up on
it) and ``itg_p95_ms`` (every gap between successive token frames,
pooled), over the requests due in the window; ``setup_s`` ends where
the window opens.

``correct``: after the window, with the server stopped and its pool
freed, a sample drawn from the seed of the requests that finished (the
longest among them) is run through the plain float32 reference over
prompt + served tokens, and the widest gap by which a served token's
logit lies below the reference's best is held to its limit. Every
request due in the window has to finish, with ``max_tokens`` token
frames equal to its done frame's tokens.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import compare
from ..inputs import weights
from ..reference import model as ref_model
from ..roofline.model_flops import Shape
from ..readings import live_blocks_peak
from ..trace import Capture, warm_up
from ..traffic import generator
from . import common

#: profiler stretches in a traced window, and the seconds after each
#: stop that the readings needing no trace leave out with it
TRACE_STRETCHES = 2
TRACE_GUARD_S = 2


class Served:
    """The program, up: weights on the device, the engine, the server
    on a free local port."""

    def __init__(self, ctx):
        from kubeflow_tpu_torch.compute import generate, serving
        s = ctx.settings
        eng = s["engine"]
        self.name = s["model_name"]
        cfg = common.port_config(ctx.config, s.get("program", {}),
                                 eng["max_context"])
        self.params = weights.make(ctx.config, ctx.seed, ctx.device,
                                   cfg.compute_dtype)
        self.engine = generate.GenerationEngine(
            self.params, cfg, eos_id=None, name=self.name,
            device=ctx.device, **eng)
        self.server = serving.ModelServer(device=ctx.device)
        self.server.register_generator(self.name, self.engine)
        self.port = self.server.start(port=0, host="127.0.0.1",
                                      transport="async")

    def stats(self):
        return dict(self.engine.stats)

    def queued(self):
        return self.engine.snapshot()["queued"]

    def stop(self):
        self.server.stop()
        self.engine = self.server = None


def _client(ctx, port, name, rate, seed, seconds):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ctx.root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
    child = subprocess.Popen(
        [sys.executable, "-m", "portbench.client"], cwd=str(ctx.root),
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    child.stdin.write(json.dumps({
        "host": "127.0.0.1", "port": port, "model": name, "mix": ctx.mix,
        "rate": rate, "seed": seed, "window_s": seconds,
        "vocab": ctx.config["vocab_size"],
        "wait_s": ctx.settings["wait_s"]}))
    child.stdin.close()
    child.stdin = None
    return child


def measure(ctx, served, rate, seed, seconds, trace=False):
    """One run of the mix against ``served`` (the closed loop, or the
    open loop at ``rate``) → the window's records and
    readings: ``{"records", "base", "w0", "w1", "stats0", "stats1",
    "queued0", "queued1"}`` and, traced, ``"trace"`` (the first stretch
    in which the profiler saw a kernel), its ``"trace_stats"`` (the
    engine's stats at its start and end) and ``"stretches"`` (for each
    stretch its stats before its start and after its stop, and the span
    it disturbed: from its start to ``TRACE_GUARD_S`` after its stop)."""
    child = _client(ctx, served.port, served.name, rate, seed, seconds)
    try:
        ready = json.loads(child.stdout.readline() or "{}")
        if "base" not in ready or ready.get("event") != "ready":
            raise RuntimeError(f"the client did not start: {ready}")
        w0 = ready["base"] + float(ctx.mix["lead_s"])
        w1 = w0 + seconds
        out = {"base": ready["base"], "w0": w0, "w1": w1, "trace": None,
               "stretches": []}
        common.sleep_until(w0)
        out["stats0"] = served.stats()
        out["queued0"] = served.queued()
        caps = []
        if trace:
            stretch = float(ctx.settings["trace_stretch_s"])
            n = TRACE_STRETCHES
            for i in range(n):
                common.sleep_until(w0 + (i + 1) * seconds / (n + 1)
                                   - stretch / 2)
                cap = Capture()
                before = served.stats()
                cap.start()
                common.sleep_until(cap.t0 + stretch)
                end = served.stats()
                cap.stop()
                caps.append((cap, (before, end)))
                out["stretches"].append(
                    (before, served.stats(), cap.t0, time.monotonic()
                     + TRACE_GUARD_S))
        common.sleep_until(w1)
        out["stats1"] = served.stats()
        out["queued1"] = served.queued()
        wait = seconds + float(ctx.mix["tail_s"]) \
            + float(ctx.settings["wait_s"]) + 60
        text, _ = child.communicate(timeout=wait)
        result = json.loads(text.strip().splitlines()[-1])
        if result.get("error"):
            raise RuntimeError(result["error"])
        out["records"] = result["records"]
        # a profiler session can come back without its kernels (seen on
        # an H100): the first stretch that has them is read
        out["stretch_kernels"] = []
        for cap, stats in caps:
            tr = cap.trace()
            out["stretch_kernels"].append(len(tr.kernels()))
            if out["trace"] is None and tr.kernels():
                out["trace"], out["trace_stats"] = tr, stats
        return out
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()


def finished(r):
    return (r["error"] is None and r["done"] is not None
            and r["done"]["reason"] == "length"
            and len(r["tokens"]) == r["max_tokens"])


def latencies(records, w1, wait_s):
    """``(ttft seconds a request, pooled token gaps, unfinished)`` over
    the requests due in the window."""
    gave_up = w1 + wait_s
    ttft, gaps, unfinished = [], [], 0
    for r in records:
        if r["phase"] != "window":
            continue
        if finished(r):
            ttft.append(r["times"][0] - r["due"])
            gaps.extend(np.diff(r["times"]).tolist())
        else:
            unfinished += 1
            ttft.append(max(gave_up, r["times"][0] if r["times"]
                            else gave_up) - r["due"])
    return ttft, gaps, unfinished


def _sample(records, seed, settings):
    """The requests the reference checks: drawn from the seed among the
    window's finished requests, the longest first, until ``check
    .served_tokens`` tokens (at most ``check.max_requests``)."""
    done = [r for r in records if r["phase"] == "window" and finished(r)]
    if not done:
        return []
    rng = np.random.default_rng(int(seed) + 17)
    longest = max(done, key=lambda r: r["prompt_len"] + len(r["tokens"]))
    rest = [r for r in done if r is not longest]
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    picked, tokens = [], 0
    for r in order:
        if tokens >= settings["served_tokens"] \
                or len(picked) >= settings["max_requests"]:
            break
        picked.append(r)
        tokens += len(r["tokens"])
    return picked


def check(ctx, params, records, rate, seconds, precisions=("fp32",)):
    """The reference over the sample → ``{precision: widest gap}`` for
    ``fp32`` (the served tokens' gap) and, for a lower precision, the
    control's reading (the gap of the token it puts first)."""
    picked = _sample(records, ctx.seed, ctx.settings["check"])
    if not picked:
        return None
    prompts = generator(ctx.mix["kind"]).prompts(
        ctx.mix, ctx.seed, ctx.config["vocab_size"],
        [r["id"] for r in picked], rate, seconds)
    dev = ctx.device
    seqs, positions, served = [], [], []
    for r in picked:
        toks = torch.tensor(r["tokens"], dtype=torch.long, device=dev)
        p = torch.as_tensor(prompts[r["id"]], device=dev)
        seqs.append(torch.cat([p, toks[:-1]]))
        positions.append(torch.arange(len(p) - 1, len(p) - 1 + len(toks),
                                      device=dev))
        served.append(toks)
    m = ref_model.Model.of(ctx.config)
    with ref_model.fp32_matmuls():
        logits = ref_model.served_logits(params, seqs, positions, m,
                                         precisions)
    out = {"fp32": max(compare.served_gap(lg, t)
                       for lg, t in zip(logits["fp32"], served)),
           "sampled_requests": len(picked),
           "sampled_tokens": sum(len(t) for t in served)}
    for p in precisions:
        if p != "fp32":
            out[p] = max(compare.control_gap(a, b) for a, b in
                         zip(logits["fp32"], logits[p]))
    return out


def _untraced(res):
    """The window's stretches that the profiler did not disturb."""
    spans, start = [], res["w0"]
    for _, _, a, b in res["stretches"]:
        spans.append((start, a))
        start = b
    return spans + [(start, res["w1"])]


def _label_at(records):
    """What the program was doing at a moment, as the client's records
    show it: a prefill (a request's first token frame less its done
    frame's ``prefill_s``, up to that frame), else decode steps (some
    request streaming), else a request waiting for its first token (in
    the HTTP plane or the engine's queue), else nothing in flight."""
    prefills, streams, waits = [], [], []
    for r in records:
        if r["send"] is None:
            continue
        if not r["times"]:
            waits.append((r["send"], float("inf")))
            continue
        first = r["times"][0]
        pre = (r["done"] or {}).get("prefill_s") or 0.0
        prefills.append((first - pre, first))
        streams.append((first, r["times"][-1]))
        waits.append((r["send"], first - pre))

    def label(t):
        for name, spans in (("engine.prefill", prefills),
                            ("engine.decode", streams),
                            ("client.await_first_token", waits)):
            if any(a <= t < b for a, b in spans):
                return name
        return "client.none_in_flight"
    return label


def run(ctx):
    from ..harness import Run
    served = Served(ctx)
    try:
        if ctx.trace:
            warm_up()
        res = measure(ctx, served, ctx.settings.get("rate"), ctx.seed,
                      ctx.seconds, trace=ctx.trace)
    finally:
        served.stop()
    peak = common.memory_peak(ctx.device)
    params = served.params
    del served
    common.release(ctx.device)
    records = res["records"]
    if ctx.trace:
        ctx.note(f"kernels seen in each traced stretch: "
                 f"{res['stretch_kernels']}")
    setup_s = res["w0"] - ctx.t_start
    window = [r for r in records if r["phase"] == "window"]
    ttft, gaps, unfinished = latencies(records, res["w1"],
                                       float(ctx.settings["wait_s"]))
    wrong = sum(1 for r in window if r["done"] is not None
                and r["done"].get("tokens") != r["tokens"])
    lateness = [r["send"] - r["due"] for r in records
                if r["send"] is not None]
    ctx.note(f"client: {len(records)} requests sent, generator late by "
             f"max {max(lateness, default=0) * 1e3:.3f} ms, p99 "
             f"{(common.percentile(lateness, 99) or 0) * 1e3:.3f} ms")
    got = check(ctx, params, records, ctx.settings.get("rate"),
                ctx.seconds)
    gap = None if got is None else got["fp32"]
    if got is not None:
        ctx.note(f"reference: {got['sampled_requests']} requests, "
                 f"{got['sampled_tokens']} served tokens compared")
    slowest = sorted(zip(ttft, window), key=lambda x: x[0])[-8:]
    ctx.note("slowest first tokens (ms, due - window start s, prompt, "
             "engine ttft ms, prefill ms): " + "; ".join(
                 f"{t * 1e3:.1f} {r['due'] - res['w0']:.2f} {r['prompt_len']}"
                 f" {(r['done'] or {}).get('ttft_s', 0) * 1e3:.1f}"
                 f" {((r['done'] or {}).get('prefill_s') or 0) * 1e3:.1f}"
                 for t, r in slowest))
    lim = ctx.settings["limits"]
    checks = {"widest_gap": (gap, lim["widest_gap"]),
              "unfinished_requests": (unfinished, 0),
              "frames_wrong": (wrong, 0)}
    w0, w1 = res["w0"], res["w1"]
    e2e = {"setup_s": setup_s,
           "gen_tokens_per_s": sum(w0 <= t < w1 for r in records
                                   for t in r["times"]) / (w1 - w0),
           "ttft_p95_ms": common.percentile(ttft, 95) * 1e3,
           "itg_p95_ms": (common.percentile(gaps, 95) or 0.0) * 1e3}
    ctx.note(f"tokens/s {e2e['gen_tokens_per_s']:.3f}, TTFT p95 "
             f"{e2e['ttft_p95_ms']:.3f} ms, ITG p95 {e2e['itg_p95_ms']:.3f} "
             f"ms")
    s0, s1 = res["stats0"], res["stats1"]
    steps = max(s1["decode_steps"] - s0["decode_steps"], 1)
    eng = ctx.settings["engine"]
    ctx.note(f"engine in the window: {steps} decode steps of "
             f"{(s1['decode_seconds_total'] - s0['decode_seconds_total'])
                * 1e3 / steps:.3f} ms, "
             f"{(s1['decode_token_slots'] - s0['decode_token_slots'])
                / steps:.2f} rows each, "
             f"{s1['prefills'] - s0['prefills']} prefills; KV pages held "
             f"at most {live_blocks_peak(records, eng['block_size'], w0, w1)}"
             f" of {eng['num_blocks']}")
    return Run(e2e=e2e, attempted=len(window), failed=unfinished + wrong,
               checks=checks, memory_peak_bytes=peak, trace=res["trace"],
               label_at=_label_at(records),
               data={"records": records,
                     "stats": (res["stats0"], res["stats1"]),
                     "trace_stats": res.get("trace_stats"),
                     "stretches": [st[:2] for st in res["stretches"]],
                     "untraced": _untraced(res),
                     "window": (w0, w1),
                     "shape": Shape.of(ctx.config),
                     "engine": ctx.settings["engine"],
                     "itemsize": torch.empty(
                         (), dtype=common.dtype_of(ctx.settings.get(
                             "program", {}).get(
                             "dtype", ctx.config["torch_dtype"]))
                     ).element_size()})
