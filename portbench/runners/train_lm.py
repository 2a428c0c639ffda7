"""Runner ``train_lm``: the port's training step on a language model.

The program under test is ``train.make_train_step`` over the
transformer's loss (``transformer.loss_fn``: the flash kernels K3–K5,
the dropless experts on K6/K7, the fp32 logits) with the port's
``AdamW`` (``train.make_optimizer``): fp32 master weights drawn on the
card from the seed, the compute dtype cast inside the graph, remat at
the port's default. The rows come from the cell's traffic mix
(``traffic/packed_lm.py``), drawn on the card in set-up.

Set-up builds the one state and step, and drives them through their
first three steps on rows 0–2 (through the window's own call); the
window then goes on stepping the same state, on the following rows in
turn. ``train_step_ms`` is the window's seconds over the steps it ran,
the window ending in a synchronize.

``correct``: the plain float32 reference (``reference/train.py``)
follows the same three steps from the same initial weights and rows,
once the window has closed and the program's state is freed. Compared:
each step's loss, each leaf's norm of the first gradient as the
optimizer got it (the program's worked out from its first moment after
one step), and each leaf's norm of the change of the weights after the
three steps, as step 4 finds them (leaves whose reference gradient is
under a thousandth of the median leaf's left out) — both by the worst
leaf, against the larger of the reference's norm of that leaf and of
the median leaf.
"""

import time

import torch

from .. import compare
from ..inputs import weights
from ..reference import train as ref_train
from ..roofline.model_flops import Shape
from ..trace import Capture, warm_up
from ..traffic import generator
from . import common


def reference_optimizer(settings):
    o = settings["optimizer"]
    return {"lr": o["learning_rate"], "b1": o["b1"], "b2": o["b2"],
            "eps": o["eps"], "weight_decay": o["weight_decay"],
            "clip_norm": o["clip_norm"], "total_steps": o["total_steps"]}


def program(ctx):
    """The port's training state and step → ``(state, step)``."""
    from kubeflow_tpu_torch.compute import train
    from kubeflow_tpu_torch.compute.models import transformer
    o = ctx.settings["optimizer"]
    cfg = common.port_config(ctx.config, ctx.settings["program"],
                             ctx.mix["seq"])
    opt = train.make_optimizer(
        learning_rate=o["learning_rate"], warmup_steps=0,
        total_steps=o["total_steps"], weight_decay=o["weight_decay"],
        b1=o["b1"], b2=o["b2"], clip_norm=o["clip_norm"])
    state = train.init_state(
        lambda generator, device: weights.make(ctx.config, ctx.seed, device,
                                               torch.float32),
        opt, device=ctx.device)
    step = train.make_train_step(train.plain_loss(transformer.loss_fn, cfg),
                                 opt)
    return state, step


def first_steps(ctx, state, step, batch):
    """Steps 1–3 → ``(state, readings)``: the losses, the first
    gradient's leaf norms, the change's leaf norms."""
    b1 = ctx.settings["optimizer"]["b1"]
    losses = []
    grad = None
    for i in range(3):
        state, metrics = step(state, batch(i))
        losses.append(float(metrics["loss"]))
        if grad is None:
            grad = {k: float(torch.linalg.vector_norm(mu) / (1 - b1))
                    for k, mu in weights.flat(state.opt_state["mu"])}
    change = {}
    with torch.no_grad():
        for k, p in weights.flat(state.params):
            start = weights.make_leaf(ctx.config, k, ctx.seed, ctx.device,
                                      torch.float32)
            change[k] = float(torch.linalg.vector_norm(p - start))
            del start
    return state, {"loss": losses, "grad": grad, "change": change}


def run(ctx):
    from ..harness import Run
    s, mix = ctx.settings, ctx.mix
    dev = ctx.device
    rows = generator(mix["kind"]).packed_rows(
        mix, ctx.seed, int(s["batches"]), ctx.config["vocab_size"], dev)

    def batch(i):
        r = rows[i % rows.shape[0]]
        return {"tokens": r[:, :-1], "targets": r[:, 1:]}

    state, step = program(ctx)
    state, prog = first_steps(ctx, state, step, batch)
    if ctx.trace:
        warm_up()
    spans = []
    trace, traced = None, 0
    trace_at = int(s["trace_skip_steps"]) if ctx.trace else -1
    common.sync(dev)
    w0 = time.monotonic()
    end = w0 + ctx.seconds
    steps, cap = 0, None
    while True:
        if steps == trace_at:
            cap = Capture()
            cap.start()
        t = time.monotonic()
        state, _ = step(state, batch(3 + steps))
        spans.append(("train.step_call", t, time.monotonic()))
        steps += 1
        if cap is not None and steps == trace_at + int(s["trace_steps"]):
            cap.stop()
            traced, done = int(s["trace_steps"]), cap
            cap = None
        if time.monotonic() >= end and steps > trace_at and cap is None:
            break
    t = time.monotonic()
    common.sync(dev)
    w1 = time.monotonic()
    spans.append(("train.sync", t, w1))
    if traced:
        trace = done.trace()
    peak = common.memory_peak(dev)
    del state, step
    kept = [rows[i].clone() for i in range(3)]
    del rows
    common.release(dev)
    ref = ref_train.follow(ctx.config, ctx.seed, kept,
                           reference_optimizer(s), dev,
                           block=int(s["reference_block"]))
    numbers, worst = compare.train_numbers(prog, ref)
    ctx.note(f"losses: program {prog['loss']} reference {ref['loss']}; "
             f"worst leaves {worst}")
    lim = s.get("limits") or {}
    checks = {k: (v, lim.get(k)) for k, v in numbers.items()}

    def label_at(t):
        for name, a, b in spans:
            if a <= t < b:
                return name
        return "train.loop"

    return Run(
        e2e={"setup_s": w0 - ctx.t_start,
             "train_step_ms": (w1 - w0) / steps * 1e3},
        attempted=steps, failed=0, checks=checks, memory_peak_bytes=peak,
        trace=trace, label_at=label_at,
        data={"shape": Shape.of(ctx.config), "batch": int(mix["batch"]),
              "seq": int(mix["seq"]), "traced_steps": traced,
              "itemsize": torch.empty((), dtype=common.dtype_of(
                  s["program"]["dtype"])).element_size(),
              "block_m": common.port_config(
                  ctx.config, s["program"], mix["seq"]).moe_gmm_block_m})
