"""Runner ``serve_afmoe``: an AFMoE model (Arcee's Trinity) served over
HTTP, as ``serve_generate`` serves a dense one.

The program under test is the same: the port's ``ModelServer`` on the
async transport, ``:generate`` streaming NDJSON, in front of a
``GenerationEngine`` built with the cell's ``engine`` settings, the
client in a child process sending the mix (``serve_generate.measure``).
What differs: the model is the port's ``PortConfig`` for the
configuration's published keys (windowed and global attention layers,
leading dense layers, routed experts with a shared one, the attention
gate, QK-norm, four norms a layer, the scaled embedding); the weights
are drawn on the card in the layout the engine serves
(``inputs/afmoe_weights.py``); ``correct`` holds the served tokens to
the plain float32 reference of ``reference/afmoe.py`` by how many of
them fall outside the reference's best. The end-to-end metrics and
``run.data`` are ``serve_generate``'s, with the model's arithmetic
(``roofline.afmoe.Afmoe``) under ``"afmoe"``.

``correct``: as ``serve_generate`` decides it, except that the served
tokens are held by the share of them that fall outside the reference's
``check.top`` best tokens at their position (``off_top_share``: more
than ``top − 1`` of the reference's logits above the served token's),
over every compared token, not by the widest gap. With random weights
this model's routing (the top 8 of 128 experts, by scores a rounding
can reorder, in 30 layers) makes the bf16 program leave the fp32
reference's argmax at about half the tokens, and its widest gap lies
near the float8 control's; outside the best 32 the two stand apart
(``PERF.md`` §2), and a request served wrong puts most of its tokens
there. The mean and widest gaps are printed beside it.
"""

import torch

from ..inputs import afmoe_weights
from ..readings import live_blocks_peak
from ..reference import afmoe as ref_afmoe
from ..reference.model import fp32_matmuls
from ..roofline.afmoe import Afmoe
from ..trace import warm_up
from ..traffic import generator
from . import common, serve_generate


def port_config(config, program, max_seq):
    """The port's ``transformer.PortConfig`` for the configuration's
    published keys, with the cell's ``program`` settings over it. The
    layer types are taken as ``global_attn_every_n_layers`` lays them
    out, which ``layer_types`` has to bear out; the family's parts
    (``transformer.FAMILIES["afmoe"]``) take sigmoid routing and the
    scaled embedding, which the keys have to state."""
    from kubeflow_tpu_torch.compute.models import transformer
    every = config["global_attn_every_n_layers"]
    types = ["full_attention" if (i + 1) % every == 0 else
             "sliding_attention"
             for i in range(config["num_hidden_layers"])]
    if config["layer_types"] != types:
        raise ValueError("layer_types is not a sliding layers' run closed "
                         "by a full one every global_attn_every_n_layers")
    if config["score_func"] != "sigmoid" or not config["mup_enabled"]:
        raise ValueError("the AFMoE family routes by sigmoid scores and "
                         "scales the embedding (score_func, mup_enabled)")
    return transformer.PortConfig(**{
        "vocab_size": config["vocab_size"], "d_model": config["hidden_size"],
        "n_layers": config["num_hidden_layers"],
        "n_heads": config["num_attention_heads"],
        "n_kv_heads": config["num_key_value_heads"],
        "d_head": config["head_dim"], "d_ff": config["intermediate_size"],
        "max_seq": int(max_seq), "rope_theta": float(config["rope_theta"]),
        "dtype": config["torch_dtype"],
        "moe_experts": config["num_experts"],
        "moe_top_k": config["num_experts_per_tok"],
        "moe_dropless": True, "moe_gmm": True,
        "norm_eps": float(config["rms_norm_eps"]),
        "sliding_window": config["sliding_window"], "global_every": every,
        "family": "afmoe", "moe_route_scale": float(config["route_scale"]),
        "moe_d_ff": config["moe_intermediate_size"],
        "moe_shared": config["num_shared_experts"],
        "moe_dense_layers": config["num_dense_layers"], **program})


class Served(serve_generate.Served):
    """The program, up: the AFMoE weights on the device, the engine, the
    server on a free local port."""

    def __init__(self, ctx):
        from kubeflow_tpu_torch.compute import generate, serving
        s = ctx.settings
        eng = s["engine"]
        self.name = s["model_name"]
        cfg = port_config(ctx.config, s.get("program", {}),
                          eng["max_context"])
        self.params = afmoe_weights.make(ctx.config, ctx.seed, ctx.device,
                                         cfg.compute_dtype)
        self.engine = generate.GenerationEngine(
            self.params, cfg, eos_id=None, name=self.name,
            device=ctx.device, **eng)
        self.server = serving.ModelServer(device=ctx.device)
        self.server.register_generator(self.name, self.engine)
        self.port = self.server.start(port=0, host="127.0.0.1",
                                      transport="async")


def reading(ref_logits, tokens, top):
    """One precision's reading of its tokens ``[n]`` against the
    reference's logits ``[n, V]``: ``(off-top flags [n], gaps [n])``,
    a token off the top where ``top`` or more of the reference's
    logits lie above its own, its gap the reference's best less its
    own."""
    got = ref_logits.gather(-1, tokens[:, None])
    return ((ref_logits > got).sum(-1) >= top,
            ref_logits.max(dim=-1).values - got[:, 0])


def check(ctx, params, records, rate, seconds, precisions=("fp32",)):
    """``serve_generate.check``'s sample against the AFMoE reference →
    ``{precision: {"off_top_share", "mean_gap", "widest_gap"}}``: the
    served tokens' for ``fp32``, and for a lower precision the
    control's (the tokens it puts first, at the same positions)."""
    picked = serve_generate._sample(records, ctx.seed,
                                    ctx.settings["check"])
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
    with fp32_matmuls():
        logits = ref_afmoe.served_logits(params, seqs, positions,
                                         ref_afmoe.Model.of(ctx.config),
                                         precisions)
    out = {"sampled_requests": len(picked),
           "sampled_tokens": sum(len(t) for t in served)}
    top = int(ctx.settings["check"]["top"])
    for p in precisions:
        off, gaps = (torch.cat(x) for x in zip(*(
            reading(ref, t if p == "fp32" else torch.argmax(low, dim=-1),
                    top)
            for ref, low, t in zip(logits["fp32"], logits[p], served))))
        out[p] = {"off_top_share": float(off.float().mean()),
                  "mean_gap": float(gaps.mean()),
                  "widest_gap": float(gaps.max())}
    return out


def comparison(got, limits):
    """The reference's check among the run's ``checks``: a reading of
    :func:`check` (the program's, or a control's) against the cell's
    limit."""
    return {"off_top_share": (None if got is None else got["off_top_share"],
                              limits["off_top_share"])}


def serve(ctx):
    """The program up and measured, then down → ``(served result,
    params, peak device bytes)``."""
    served = Served(ctx)
    try:
        if ctx.trace:
            warm_up()
        res = serve_generate.measure(ctx, served, ctx.settings.get("rate"),
                                     ctx.seed, ctx.seconds, trace=ctx.trace)
    finally:
        served.stop()
    peak = common.memory_peak(ctx.device)
    params = served.params
    del served
    common.release(ctx.device)
    return res, params, peak


def run(ctx):
    from ..harness import Run
    res, params, peak = serve(ctx)
    records = res["records"]
    if ctx.trace:
        ctx.note(f"kernels seen in each traced stretch: "
                 f"{res['stretch_kernels']}")
    w0, w1 = res["w0"], res["w1"]
    window = [r for r in records if r["phase"] == "window"]
    ttft, gaps, unfinished = serve_generate.latencies(
        records, w1, float(ctx.settings["wait_s"]))
    wrong = sum(1 for r in window if r["done"] is not None
                and r["done"].get("tokens") != r["tokens"])
    got = check(ctx, params, records, ctx.settings.get("rate"), ctx.seconds)
    if got is not None:
        ctx.note(f"reference: {got['sampled_requests']} requests, "
                 f"{got['sampled_tokens']} served tokens compared; "
                 f"{got['fp32']}")
    e2e = {"setup_s": w0 - ctx.t_start,
           "gen_tokens_per_s": sum(w0 <= t < w1 for r in records
                                   for t in r["times"]) / (w1 - w0),
           "ttft_p95_ms": common.percentile(ttft, 95) * 1e3,
           "itg_p95_ms": (common.percentile(gaps, 95) or 0.0) * 1e3}
    s0, s1 = res["stats0"], res["stats1"]
    steps = max(s1["decode_steps"] - s0["decode_steps"], 1)
    eng = ctx.settings["engine"]
    pages = live_blocks_peak(records, eng["block_size"], w0, w1)
    ctx.note(f"tokens/s {e2e['gen_tokens_per_s']:.3f}, TTFT p95 "
             f"{e2e['ttft_p95_ms']:.3f} ms, ITG p95 {e2e['itg_p95_ms']:.3f} "
             f"ms; engine in the window: {steps} decode steps of "
             f"{(s1['decode_seconds_total'] - s0['decode_seconds_total'])
                * 1e3 / steps:.3f} ms, "
             f"{(s1['decode_token_slots'] - s0['decode_token_slots'])
                / steps:.2f} rows each, "
             f"{s1['prefills'] - s0['prefills']} prefills, KV pages held "
             f"at most {pages} of {eng['num_blocks']}; peak {peak} bytes")
    checks = {**comparison(got and got["fp32"], ctx.settings["limits"]),
              "unfinished_requests": (unfinished, 0),
              "frames_wrong": (wrong, 0)}
    return Run(e2e=e2e, attempted=len(window), failed=unfinished + wrong,
               checks=checks, memory_peak_bytes=peak, trace=res["trace"],
               label_at=serve_generate._label_at(records),
               data={"records": records,
                     "stats": (res["stats0"], res["stats1"]),
                     "trace_stats": res.get("trace_stats"),
                     "stretches": [st[:2] for st in res["stretches"]],
                     "untraced": serve_generate._untraced(res),
                     "window": (w0, w1),
                     "afmoe": Afmoe.of(ctx.config),
                     "engine": eng,
                     "itemsize": torch.empty(
                         (), dtype=common.dtype_of(ctx.settings.get(
                             "program", {}).get(
                             "dtype", ctx.config["torch_dtype"]))
                     ).element_size()})
