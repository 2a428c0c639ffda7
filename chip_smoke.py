"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kubeflow_tpu_torch`` end to end on the card and exits non-zero
if any phase fails:

1. device — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them, and the torch and CUDA versions;
2. build — compiles every hand-written kernel from ``csrc/`` (one
   ``nvcc`` per source, all at once) into ``build/``; the row lists
   every kernel's registers and spills as ptxas printed them (the
   tensor-core K2/K3/K4/K5 and the wgmma K6/K7 beside the CUDA-core
   ones); fails when ptxas serialized any kernel's wgmma (C7515);
3. kernels — each kernel against its plain PyTorch version on the card
   at the serving path's shapes, fp32 (tolerance 1e-4) and bf16 (2e-2),
   with its time, the plain version's time, one PyTorch library call's
   time (SDPA) and the least time the card could take: K1 (decode
   read; its row names the key walk's splits, more than one, and the
   grid's blocks), K3 (flash forward) and K2 (chunk-after-prefix read)
   at a 256-row prefill chunk behind 768 cached positions, a 64-row
   prefix-hit suffix behind 512, and an 8-slot verify of 5 rows with
   per-slot prefixes (each K2 row names the bf16 key walk's splits and
   the grid's blocks); K1-i8 and K2-i8 (the int8-page reads) at the
   same shapes, the pages quantized from the same draw, each beside the
   float kernel's time; and bf16 K1 and K1-i8 over a lone 1024-token
   slot, side rows kept out of the ``kernels`` line;
4. engine — the bench-LM flagship (vocab 32768, d_model 1024, 12
   layers, GQA 8:2, bf16, random weights from a seed) served by the
   port's ``GenerationEngine``: 12 concurrent requests over 8 slots,
   each to its full token budget, plus one full-width
   ``transformer.apply``; engine_i8 — the same 12 requests on an int8
   pool (``kv_dtype="int8"``): decode reads on K1-i8 and never on K1,
   page bytes exactly half the bf16 pool's, tokens/s and decode-step ms
   beside the bf16 engine's;
5. prefix — the same flagship with the prefix cache and 256-token
   prefill chunks: 3 cohorts x 4 requests sharing a 512-token prefix
   (one lead each first, then the rest beside two cold 900-token
   prompts), every request to its full budget, >= 9 prefix hits, more
   prefill chunks than prefills; prefix_i8 — the same on an int8 pool,
   read by K2-i8 and K1-i8 and never by K2 or K1;
6. speculative — the flagship (upper layers dampened) verifying the
   proposals of its own first 2 layers, ``spec_k=4``, 8 requests;
7. conformance — the fp32 engine against the port's cache-free oracle
   (dense attention): tokens identical, logits within 1e-3 (TF32 off),
   the bf16 engine's logits within 0.2 / 0.1 of that fp32 oracle, and
   the fp32 engine on an int8 pool within 0.08 / 0.05 of it and more
   than 1e-5 away;
8. identity — fp32 tokens of the prefix/chunked engine and of the
   speculative engine equal the plain engine's (``prefix_cache=False``,
   monolithic prefill) on 4 short requests each, and the speculative
   engine's on an int8 pool the plain int8 engine's, apart from steps
   where the plain engine's top-2 logit gap is below 1e-3; the bf16
   agreement is printed, not asserted;
9. wire — the bf16 flagship engine (8 slots, paged backend, prefix cache
   on) behind the port's ``ModelServer`` on 127.0.0.1 (threaded
   transport): 12 keep-alive clients POST the engine phase's 12 requests
   to ``:generate`` together; every stream is 200 NDJSON with contiguous
   token indices, its done frame holds the streamed tokens (each budget
   spent) and ``X-TTFT-Ms`` is its ``ttft_s`` x 1000; K1 and K3 launch;
   the streamed tokens equal the same engine's in-process tokens for the
   same requests right after (where bf16 rounding on the prefix-cache
   path makes them differ, the comparison runs again in fp32 at full
   width and must hold there); tokens/s, TTFT p50/max and ITG p50 from
   the done frames beside the in-process tokens/s;
10. wire_cmd — ``python -m kubeflow_tpu_torch.cmd model-server`` as a
   subprocess at the flagship's width under the JAX entry's knobs (MHA:
   there is no KV-head knob), 8 slots, 256-token prefill chunks:
   ``/healthz``, ``/v1/models/default`` on ``cuda:0``, a first request
   timed alone (the replica's cold start), 4 streams (one a
   700-token prompt: more prefill chunks than prefills, K2) sent as the
   tenants ``crawler`` and ``acme`` of its ``QOS_TENANTS`` ledger (each
   ``X-QoS-Class`` the tenant's class), the tokens counted on
   ``/metrics`` (and per tenant under ``serving_qos_tokens_total``), one
   two-hop request (``:prefill`` on it, ``:attach`` on a second
   ``model-server`` started with ``GEN_ROLE=decode``), a 503 after
   ``POST /admin/drain``, and SIGTERM ending both with 0 within 30 s;
11. qos — QoS classes and preemptible decoding on the bf16 flagship at
   full width and depth (4 slots, block 16, prefix cache on): 8 batch
   streams (tenant ``crawler``) of distinct 512-token prompts, 128
   tokens each, then, once every slot has emitted, 8 interactive
   streams (``acme``) of distinct 64-token prompts, 16 tokens each, 100
   ms apart; run on a FIFO engine (``preemption=False``: no
   suspension, admission in submit order, no K2) and on a preempting
   one (at least one suspension, as many resumes, each skipping the 32
   retained blocks and re-prefilling at most 2 through K2, exactly 12
   K2 launches a resume, interactive TTFT p95 at least 2x better than
   FIFO's); every stream spends its budget with contiguous indices; K1
   and K3 launch on both; the bf16 preempted streams' agreement with
   FIFO's is printed, and in fp32 at full width (2 slots, 3 batch
   streams x 48 tokens, 2 interactive) every preempted stream equals the
   uninterrupted engine's tokens but at top-2 logit gaps below 1e-3;
   qos_i8 — the preemption run on an int8 pool: resumes on K2-i8
   (exactly 12 a resume), decode on K1-i8, never K1 or K2;
12. disagg — prefill/decode disaggregation on the bf16 flagship (block
   16): a prefill-role engine (1 slot) exports the 896-token intruder's
   56 blocks (K3 exactly 12 times, 11,010,048 page bytes), the bundle
   goes through ``encode_kv_bundle`` → bytes → ``decode_kv_bundle``, and
   one schedule of 4 short streams (64-token prompts, 128 tokens) runs
   in three topologies: baseline, colocated (the intruder, budget 8,
   submitted to a role-both engine once every stream has emitted 16
   tokens) and disagg (the bundle imported at that point by a
   decode-role engine, 5 slots, the prefix cache off): no prefill and
   no K3 for the intruder, K1 decodes it, its pages land bit for bit,
   its first token is the bundle's, each engine's migration view shows
   its one export or import; a follow-up sharing 512 tokens of the
   imported prompt on a prefix-caching decode engine is a hit (K2 12
   times); in fp32 at full width the intruder's disagg tokens equal the
   colocated engine's and the reference's but at top-2 gaps below 1e-3;
   the short streams' ITG p50/p99/max per topology, the intruder's first
   token, the export's device→host ms and ``serving_kv_migration_seconds``
   printed; disagg_i8 — the same on an int8 pool (K1-i8, never K1 or K2,
   half the page bytes, 172,032 scale bytes); disagg_wire — two port
   ``ModelServer``s over a prefill-role and a decode-role engine, this
   script the router: ``:prefill`` then ``:attach`` (``X-KV-Bytes-Migrated``
   right, tokens equal the same hop in process), an int8 bundle on the
   bf16 pool 400 naming ``dtype`` (counted on ``/metrics``), ``:attach`` on
   the prefill-role server 400 naming ``role``;
13. predict — ResNet-50 (bf16, 1000 classes, ``init_params`` from a
   seed as ``bench.py`` serves it) served over ``:predict`` by the port's
   ``ModelServer`` on 127.0.0.1 as ``resnet50`` and ``resnet50-int8``
   (``bench.py:268-287``'s predict functions, residency-managed), and in
   fp32: 8 keep-alive clients x 4 ``application/x-tensor`` requests of
   one 224 x 224 x 3 image, 4 JSON ``instances`` and 4 b64 requests, one
   ``:predictStream`` of 32 lines; every row within 2e-2 of the
   in-process predict of its image (fp32: 1e-4 of ``resnet.apply``),
   fewer device calls than requests and a mean
   ``serving_batch_occupancy_requests`` above 1, the int8 model at most
   0.3x the bf16 model's bytes (its argmax agreement printed); images/s
   and latency p50/p99 per format, ``X-Inference-Time-Ms`` p50, one
   batch of 8 profiled (device ms, idle share); predict_residency — two
   managed ResNet-50s under a budget of 1.5 models: a predict on one
   evicts the other, ``torch.cuda.memory_allocated`` falling by at least
   0.9x its bytes, and the next predict reloads it; a canary at weight
   0.5 splits ``X-Served-Version`` as its seeded rng dictates, then
   promote and rollback; predict_cmd — three ``model-server`` replicas
   without ``MODEL_GENERATE`` on the card (the stock MLP,
   ``MODEL_DEVICE_MS=5`` under 8 clients beside its 200 rows/s,
   ``MODEL_MODULE``), each ended by SIGTERM with 0;
14. mesh — the engine's tensor mesh on the one card:
   ``mesh_for_generation(tensor=2, devices=[cuda:0, cuda:0])``, two
   shards of the bf16 flagship (4 q and 1 KV head each, half of every
   pool block), the engine phase's 12 requests on one locked schedule
   beside the unsharded engine and a ``tensor=1`` mesh: tp 1 tokens and
   pool bytes equal the unsharded engine's; tp 2 tokens and pool bytes
   compared with the shards' split count at the model's KV heads and,
   in a second run, at their own; K3 24 a cold prefill, K2 24 a prefix
   hit, K1 24 a decode step (twice the unsharded counts); an export from
   tp 2 equal to the unsharded bundle byte for byte; at 8 blocks a
   shard the tp 2 pool admits twice the sequences; a prefix + 256-token
   chunk schedule; fp32 at full width: tp 2 tokens equal the unsharded
   engine's but at top-2 gaps below 1e-3, logits within 1e-3 of the
   cache-free oracle; bf16 tp 2 and ``row_shard`` within 0.2 / 0.1 of
   it; decode-step ms, ``measure_collective_share()`` and
   ``collective_bytes_per_step()`` printed as two shards on one card,
   which makes no speed claim;
15. train — the flagship at full width and depth (bf16, ``remat=False``)
   trained by the port's ``compute.train``: ``init_state`` →
   ``make_train_step(plain_loss(transformer.loss_fn))`` → ``fit`` over
   one repeated ``synthetic_lm`` batch of 16 x 1024 tokens, 2 warm
   steps then 5 timed (lr 1e-3, warmup 1): step ms, tokens/s, MFU
   (``flops_per_token`` x tokens / step s / the card's bf16 peak), peak
   memory and the loss per step; the loss must be finite and fall, and
   every step launch K3, K4 and K5 exactly 12 times each; then one step
   profiled through the port's ``profiler`` (device ms by kernel
   group, the device's idle share);
16. train conformance — fp32, TF32 off, flagship width, 2 layers, batch
   2 x 1024: the loss and every gradient leaf through K3/K4/K5 against
   ``attention="dense"`` (plain PyTorch autograd) on the card, loss
   within 1e-5 relative, each leaf's max |Δg| within 1e-3 of that
   leaf's max |g|; and at full depth (12 layers, fp32) ``remat=True``
   against ``remat=False``: gradients within 1e-5 of each leaf's max
   |g| (the embedding's scatter-add sums in another order each run),
   24 K3 launches against 12, 12 of K4 and K5 in both;
17. moe_apply — the MoE flagship (``moe_config``: vocab 32000, d_model
   1024, 8 layers, 8 heads MHA, ff 2816, 8 experts top-2, dropless on
   the grouped matmul, bf16, random weights from a seed):
   ``transformer.apply`` on 1 x 1024 tokens, finite logits, exactly 16
   K6 and 8 K3 launches;
18. moe_train — the same model trained (``remat=False``, one repeated
   8 x 1024 batch, 2 warm + 3 timed steps): step ms, tokens/s, MFU by
   JAX's ``flops_per_token`` (which counts the dense MLP once), peak
   memory, losses, ``moe_aux`` and the padded-row share; the loss falls
   and every step launches K6 32, K7 16 and K3/K4/K5 8 times each; then
   one step profiled (``moe_train_profile``);
19. moe_conformance — fp32, TF32 off, MoE width, 2 layers, batch 2 x
   1024: the loss and every gradient leaf through K6/K7 against the
   plain ragged engine (``moe_gmm=False``), loss within 1e-5 relative,
   each leaf within 1e-3 of its max |g|, ``apply`` logits within 1e-3;
20. resnet_eval — ResNet-50 (bf16, random weights and randomised BN from
   a seed) at batch 256, 224 px in eval mode: every identity block's
   input through both ``resnet._block`` and K8
   (``fused_bottleneck_eval``), agreeing within 3e-2 of the block
   output's max |value| in bf16 (the roundings differ) and 1e-4 in fp32
   (batch 8); then one forward with the 12 identity blocks through K8
   (exactly 12 launches, finite logits within 5e-2 of the unfused
   forward's, statistics untouched) and samples/s of the unfused and the
   K8 forward;
21. resnet_train — ResNet-50 trained (bf16, ``init_state(extra=stats)``
   → ``make_train_step(stateful_loss(resnet.loss_fn))`` → ``fit`` over
   one repeated 256 x 224 x 224 x 3 batch, 2 warm + 3 timed steps): step
   ms, samples/s, MFU by ``flops_per_sample``, peak memory; the loss
   falls and the running means move; then one step profiled
   (``resnet_train_profile``);
22. bert_train — bert-base (bf16, ``remat=False``, per-layer weights) on
   one repeated 16 x 512 ``mlm_batch``, 2 warm + 3 timed steps: step ms,
   tokens/s, MFU; the loss falls and every step launches K3, K4 and K5
   12 times each; then one step profiled; and bert_conformance — fp32, 2
   layers, 2 x 512: loss and every gradient leaf through K3-K5 (no
   causal mask, head_dim 64) against ``attention="dense"``, 1e-5 / 1e-3
   of each leaf's max |g|;
23. train_mesh — the flagship (bf16, ``remat=False``) trained on a
   ``data=2, tensor=2`` mesh over four positions of the one card
   (``init_state(mesh=)`` → ``make_train_step(mesh=)`` → ``fit(mesh=)``,
   3 steps on one 16 x 1024 batch; 4 q and 1 KV head a tensor shard):
   the loss falls, K3, K4 and K5 launch 12 x 4 = 48 times a step each,
   every replicated copy of the params, moments and state is byte-equal
   after the steps and every gathered param finite; step ms beside the
   ``train`` phase's (one card: no speed claim), peak memory and the
   telemetry's ``live_mfu`` over the mesh's one distinct card;
   train_mesh_conformance — fp32, TF32 off, flagship width, 2 layers,
   batch 4 x 1024 on ``data=2, fsdp=2, tensor=2`` (eight positions)
   against the port's unsharded step on the same weights: loss within
   1e-5 relative, every leaf's gradient within 1e-3 of its max |g|, the
   params after one update by ``tests/test_torch_train.py``'s rule;
   bert_mesh — bert-base (bf16, per-layer weights) on ``data=2, fsdp=2,
   tensor=2``, 3 steps on one 16 x 512 batch: the loss falls, K3–K5 96
   a step each; fp32 at 2 layers on 8 rows whose pieces hold different
   masked-token counts: the mesh loss within 1e-5 of the unsharded one;
   resnet_mesh — ResNet-50 (bf16) on ``data=2``, 2 steps on one 256 x
   224² batch (sync BN; cuDNN convolutions, no hand-written kernel);
   fp32 at depth 50 on 8 images, one step at rate 1e-3: with BN
   randomised the loss and every running statistic within 1e-5 of the
   unsharded step's; at the seed's init the gradient norm within 1e-5
   and the params by ``test_torch_train.py``'s rule over all elements;
   the ring and pipeline phases (``pipeline_1f1b`` on ``pipeline=2``
   and on ``data=2 x pipeline=2``: K3 384, K4/K5 192, the loss within
   1e-2 of the pipeline-only 1F1B's and GPipe's; fp32 at 2 layers on
   three meshes, ``tensor=2`` among them, against plain autograd);
   moe_mesh — the MoE flagship (bf16) on
   ``data=2, expert=2`` over four positions, 2 warm + 3 timed steps on
   ``moe_train``'s 8 x 1024 batch: K6 128, K7 64 and K3–K5 16 a step
   (each expert shard's K6/K7 for each piece), copies byte-equal, step
   1 within 1e-3 of ``moe_train``'s; moe_mesh_conformance — fp32, 2
   layers on ``data=2, expert=2, tensor=2``: dropless in 2 GPipe stages
   and the capacity dispatch against one device replaying the mesh's
   top-k choices, loss 1e-6, leaves 1e-5; process_mesh — two gloo
   processes on ``cuda:0``, ``data=2`` across them, in one subprocess
   pair: the flagship's ``train`` cell, bert-base's ``bert_train`` and
   ResNet-50's ``resnet_train`` (sync BN over the gang), half the
   batch a rank, ``PROCESS_STEPS`` (4) steps each: the ranks
   byte-equal after every step (ResNet's running statistics too),
   every step's loss within 1e-3 of the one-process phase's same step,
   K3–K5 12 a step a rank for the flagship and BERT, the gradient
   all_reduce's share of the step and, in the last step alone, the
   small collectives'; then fp32
   ResNet-50 on 8 images, 4 a rank, one step: loss, running statistics
   and gradient norm within 1e-5 of one process's ``data=2`` mesh and
   the params by ``test_torch_train.py``'s rule;
   slice_worker — ``python -m kubeflow_tpu_torch.cmd slice-worker`` as a
   gang of 2: a fault at step 3 (exit 17), the gang restarted, resumed
   from step 2 and equal to an uninterrupted gang's within 1e-6;
24. sweep — ``run_mnist_sweep`` of 8 trials in 2 shape buckets, 30
   steps, equal within 1e-5 to 8 calls of ``run_mnist_trial``; wall
   seconds of both;
25. the ``kernels`` line — every ported kernel with its launches on each
   path (counts zeroed just before a path, read just after), its max
   |Δ| and its times.

Kernel phase, the backward: K4 (dq) and K5 (dk, dv) against the plain
backward at the train step's shape (B 16, S 1024, 8 q / 2 kv heads, D
128, causal), fp32 and bf16, within 1e-4 / 2e-2 of the plain version's
max |value|; K3 is also measured at B 16 beside them. The library
yardstick of the backward is SDPA's backward over repeated
K/V (one ``autograd.grad`` over a retained forward): it covers dq,
dk and dv together. K3-K5 again at the MoE step's MHA shape (B 8, 8 q /
8 kv heads).

Kernel phase, MoE: K6 at the MoE step's four call sites (gate|up
``[17408, 1024] x [8, 1024, 5632]``, down ``[17408, 2816] x [8, 2816,
1024]`` and their dx with the weights read transposed) and K7 at both dw
sites, routing from a seeded uniform draw, fp32 and bf16, within 1e-4 /
2e-2 of the plain version's max |value|; and K6 at gate|up and K7 at dw
gate|up in bf16 once more under a skewed routing (expert 0 takes half
the rows), held to the same tolerance, side rows kept out of the
``kernels`` line. The
yardstick is one
``torch._grouped_mm`` call with the layout's group offsets where the
card's torch takes the dtype, else a dense ``torch.matmul`` of the same
FLOPs; each row names which.

Kernel phase, BERT and ResNet: K3-K5 at the BERT step's shape (B 16, S
512, 12 heads of 64, no causal mask), and K8 at the identity block of
each ResNet-50 stage (batch 256: 56x56x256, 28x28x512, 14x14x1024,
7x7x2048, bottleneck C/4) with BN scale, bias, mean and variance
randomised, fp32 and bf16, within 1e-4 / 2e-2 of the plain version's max
|value|. K8's yardstick is the port's unfused ``resnet._block`` in eval
mode: three cuDNN convolutions with the BN multiply-adds between them.
Each K8 row also names its plan's block tile and step depth, the
registers and spills of the instantiation it launches (from
the build row) and the weight bytes its blocks pull from L2, per ms.

One JSON object per phase, then the run's total seconds, the card line,
the ``kernels`` line and the last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --k8-bands 2,3,4,5,6,7,8,10,14

is a side measurement, not the smoke run: after device and build it
times K8 in bf16 at each ResNet-50 stage over those band heights (the
output rows one thread block computes) beside the one its plan chooses,
and prints the card line last.
"""

import dataclasses
import functools
import itertools
import json
import os
import re
import statistics
import sys
import time
import traceback

import numpy as np

H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16
              "float32": 67e12}       # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, flush, iters=20):
    """Mean ms per call on the card: CUDA events around ``iters`` calls
    issued back to back, each after a 64 MiB write that flushes the L2
    cache (so every call finds its inputs in device memory, as the
    serving path does), minus the same loop of flushes alone. Where the
    host issues a call more slowly than the card runs it, the host's
    time is what shows."""
    import torch

    def loop(body):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fn()
    loop(flush.zero_)      # untimed: the clocks are up before the baseline
    flush_only = loop(flush.zero_)
    return loop(lambda: (flush.zero_(), fn())) - flush_only


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    from kubeflow_tpu_torch.compute import device as device_lib
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this "
                           "smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_lib.card_identity()
    info = {"phase": "device", "card": card,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32}}
    emit(info)
    return info


def ptxas_entries(log):
    """``nvcc -Xptxas -v`` output → ``{kernel: {"registers", "spill_stores",
    "spill_loads", "lines"}}``, the kernel named as ``name<args>`` from
    its mangled symbol (``float``/``bf16``, head_dim)."""
    entries, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _demangle(m.group(1))
            entries[name] = {"registers": None, "spill_stores": None,
                             "spill_loads": None, "lines": []}
            continue
        if name is None or not ("registers" in ln or "spill" in ln):
            continue
        e = entries[name]
        e["lines"].append(ln.strip())
        if m := re.search(r"Used (\d+) registers", ln):
            e["registers"] = int(m.group(1))
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln):
            e["spill_stores"], e["spill_loads"] = map(int, m.groups())
    return entries


def _demangle(symbol):
    """``_ZN<len><namespace><len><name>I<args>E...`` → ``name<args>``
    (``float``/``bf16``/``int8``, integers and booleans); any other
    symbol as it is."""
    parts, rest = [], symbol[3:] if symbol.startswith("_ZN") else ""
    while m := re.match(r"(\d+)", rest):
        n = int(m.group(1))
        parts.append(rest[m.end():m.end() + n])
        rest = rest[m.end() + n:]
    if not parts:
        return symbol
    if not rest.startswith("I"):
        return parts[-1]
    args, rest = [], rest[1:]
    tokens = ((r"Li(\d+)E", None), (r"Lb0E", "false"), (r"Lb1E", "true"),
              (r"13__nv_bfloat16", "bf16"), (r"a", "int8"), (r"f", "float"))
    while rest and not rest.startswith("E"):
        for pattern, shown in tokens:
            if t := re.match(pattern, rest):
                args.append(shown or t.group(1))
                rest = rest[t.end():]
                break
        else:
            return symbol      # an argument kind not listed: keep it whole
    return f"{parts[-1]}<{', '.join(args)}>"


def serialized_wgmma(log):
    """The lines of an ``nvcc -Xptxas -v`` log in which ptxas reports
    warning C7515: the wgmma of a kernel serialized (an accumulator
    touched by another instruction inside the pipeline), every product
    waiting for the one before."""
    return [ln.strip() for ln in log.splitlines() if "C7515" in ln]


def phase_build():
    """Build every kernel; the row lists each kernel's registers and
    spills a thread as ptxas reported them (``name<args>: lines``). Fails
    when ptxas serialized the wgmma of any kernel (C7515). Returns
    ``{source: ptxas_entries}`` (empty for a library built before)."""
    from kubeflow_tpu_torch.compute.ops import _build
    seconds = _build.build()
    report, serialized, built = {}, [], {}
    for name in _build.SOURCES:
        log = _build.ptxas_report(name) or ""
        entries = built[name] = ptxas_entries(log)
        report[name] = [f"{k}: {' | '.join(e['lines'])}"
                        for k, e in entries.items()]
        serialized += serialized_wgmma(log)
        _build.load(name)
    emit({"phase": "build", "seconds": seconds, "ptxas": report,
          "serialized_wgmma": serialized})
    if serialized:
        raise RuntimeError(f"ptxas serialized wgmma (C7515): {serialized}")
    return built


DECODE_LENGTHS = [0, 1, 17, 100, 333, 512, 777, 1024]


def _paged_case(dtype, seed=0, lengths=DECODE_LENGTHS):
    """K1 at the serving path's shape: 8 slots, 2 kv heads x GQA 4,
    head_dim 128, block 16, 64 blocks per slot, ragged lengths (or one
    slot a length of ``lengths``)."""
    import torch
    S, kv, n_rep, D, bs, bps = len(lengths), 2, 4, 128, 16, 64
    g = torch.Generator().manual_seed(seed)
    N = S * bps
    kc = torch.randn((N, bs, kv, D), generator=g).to("cuda", dtype)
    vc = torch.randn((N, bs, kv, D), generator=g).to("cuda", dtype)
    q = torch.randn((S, 1, kv * n_rep, D), generator=g).to("cuda", dtype)
    tables = torch.randperm(N, generator=g).reshape(S, bps).to(
        "cuda", torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, (kc, vc), tables, lengths, n_rep, bs


def _int8_pool(pages):
    """A float ``(k, v)`` pool → the engine's int8 quadruple
    (``quantize.kv_quantize``), quantized from the same draw."""
    from kubeflow_tpu_torch.compute import quantize
    (kq, ks), (vq, vs) = (quantize.kv_quantize(p) for p in pages)
    return kq, vq, ks, vs


def _pool_bytes(pages, n_pos):
    """Bytes of the K and V rows of ``n_pos`` positions, every kv head,
    read once: the pages, plus the fp32 scales of an int8 pool."""
    kv, D = pages[0].shape[2:]
    per_pos = 2 * kv * D * pages[0].element_size()
    if len(pages) == 4:
        per_pos += 2 * kv * 4
    return n_pos * per_pos


def decode_yardsticks(q, pages, tables, lengths, n_rep, bs, flush):
    """K1's yardsticks at one input → ``(library_ms, bound_ms,
    bound_by)``: SDPA over the gathered, masked context (the gather, and
    an int8 pool's dequant, are set-up and not timed), and the least
    time the card could take (q read and out written once, the K/V rows
    of every valid position read once, the tables and lengths)."""
    import torch
    import torch.nn.functional as F
    from kubeflow_tpu_torch.compute.ops import paged_attention as ops
    S, _, H, D = q.shape
    T = tables.shape[1] * bs
    k_all, v_all = (p[tables.long()].reshape(S, T, -1, D)
                    .repeat_interleave(n_rep, dim=2).transpose(1, 2)
                    for p in ops._dequant_kernel(pages, q.dtype))
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, k_all, v_all, attn_mask=mask), flush=flush)
    n_tok = int(lengths.sum())
    bytes_moved = (2 * q.numel() * q.element_size()
                   + _pool_bytes(pages, n_tok)
                   + tables.numel() * 4 + lengths.numel() * 4)
    flops = 4 * n_tok * H * D
    bound_ms, bound_by = bound(bytes_moved, flops,
                               str(q.dtype).removeprefix("torch."))
    return library_ms, bound_ms, bound_by


def check_paged(dtype_name, flush, int8=False, lengths=DECODE_LENGTHS):
    """K1 (or, ``int8``, K1-i8 on the same draw quantized, beside the
    float K1's time at the same shape) against its plain version; the
    row names the key walk's splits and the grid's blocks, and requires
    more than one split."""
    import torch
    from kubeflow_tpu_torch.compute.ops import paged_attention as ops
    dtype = getattr(torch, dtype_name)
    q, pages, tables, lengths, n_rep, bs = _paged_case(dtype,
                                                       lengths=lengths)
    float_pages = pages
    if int8:
        pages = _int8_pool(pages)
    kw = dict(block_size=bs, n_rep=n_rep)
    got = ops.paged_decode_attention(q, pages, tables, lengths, **kw)
    want = ops.paged_decode_reference(q, pages, tables, lengths, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.isfinite(got.float()).all()) and err <= TOL[dtype_name]
    ms = time_ms(lambda: ops.paged_decode_attention(
        q, pages, tables, lengths, **kw), flush=flush)
    plain_ms = time_ms(lambda: ops.paged_decode_reference(
        q, pages, tables, lengths, **kw), flush=flush)
    library_ms, bound_ms, bound_by = decode_yardsticks(
        q, pages, tables, lengths, n_rep, bs, flush)
    S, _, H, D = q.shape
    # the grid: splits x kv heads x slots
    kv = H // n_rep
    splits = ops.decode_splits(S, kv, bs, tables.shape[1],
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count)
    ok = ok and splits > 1
    row = {"phase": "kernels",
           "kernel": "paged_decode_i8" if int8 else "paged_decode",
           "dtype": dtype_name,
           "shape": {"slots": S, "heads": H, "kv_heads": kv,
                     "head_dim": D, "block_size": bs,
                     "blocks_per_slot": tables.shape[1],
                     "lengths": lengths.tolist(), "splits": splits,
                     "blocks": splits * kv * S},
           "max_abs_err": err, "tol": TOL[dtype_name], "ok": ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if int8:
        row["float_kernel_ms"] = time_ms(lambda: ops.paged_decode_attention(
            q, float_pages, tables, lengths, **kw), flush=flush)
    emit(row)
    return row


def check_flash(dtype_name, S, flush, B=1, kv=2, H=8, D=128, causal=True):
    import torch
    import torch.nn.functional as F
    from kubeflow_tpu_torch.compute.ops import flash_attention as ops
    dtype = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn((B, S, h, D), generator=g).to("cuda", dtype)
               for h in (H, kv, kv))
    out, lse = ops.flash_attention(q, k, v, causal=causal)
    want_out, want_lse = ops.flash_attention_reference(q, k, v,
                                                       causal=causal)
    torch.cuda.synchronize()
    err = max(float((out.float() - want_out.float()).abs().max()),
              float((lse - want_lse).abs().max()))
    ok = (bool(torch.isfinite(out.float()).all())
          and bool(torch.isfinite(lse).all()) and err <= TOL[dtype_name])
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                 flush=flush)
    plain_ms = time_ms(lambda: ops.flash_attention_reference(
        q, k, v, causal=causal), flush=flush)
    n_rep = H // kv
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(n_rep, dim=2).transpose(1, 2)
              for t in (k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), flush=flush)
    itemsize = q.element_size()
    bytes_moved = ((2 * q.numel() + k.numel() + v.numel()) * itemsize
                   + lse.numel() * 4)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    flops = 4 * D * pairs
    bound_ms, bound_by = bound(bytes_moved, flops, dtype_name)
    row = {"phase": "kernels", "kernel": "flash_fwd", "dtype": dtype_name,
           "shape": {"batch": B, "seq": S, "heads": H, "kv_heads": kv,
                     "head_dim": D, "causal": causal},
           "max_abs_err": err, "tol": TOL[dtype_name], "ok": ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": flops / ms / 1e9}
    emit(row)
    return row


TRAIN_ATTN = dict(B=16, S=1024, H=8, kv=2, D=128)   # the train step's
MOE_ATTN = dict(B=8, S=1024, H=8, kv=8, D=128)      # the MoE step's (MHA)
# the BERT-base step's: MHA, head_dim 64, no causal mask
BERT_ATTN = dict(B=16, S=512, H=12, kv=12, D=64, causal=False)


def check_flash_bwd(dtype_name, flush, shape=TRAIN_ATTN):
    """K4 and K5 against the plain backward at a train step's shape →
    one row per kernel. Errors and the tolerance are relative to the
    plain gradient's max |value|."""
    import torch
    import torch.nn.functional as F
    from kubeflow_tpu_torch.compute.ops import flash_attention as ops
    dtype = getattr(torch, dtype_name)
    B, S, H, kv, D = (shape[k] for k in ("B", "S", "H", "kv", "D"))
    causal = shape.get("causal", True)
    g = torch.Generator().manual_seed(11)
    q, do = (torch.randn((B, S, H, D), generator=g).to("cuda", dtype)
             for _ in range(2))
    k, v = (torch.randn((B, S, kv, D), generator=g).to("cuda", dtype)
            for _ in range(2))
    out, lse = ops.flash_attention(q, k, v, causal=causal)
    delta = ops.attention_delta(out, do)
    args = (q, k, v, do, lse, delta, causal)
    dq = ops.flash_attention_bwd_dq(*args)
    dk, dv = ops.flash_attention_bwd_dkv(*args)
    want = ops._bwd_reference(*args, None)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        diff = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        errs[name] = {"max_abs_err": diff, "rel": diff / scale,
                      "finite": bool(torch.isfinite(got.float()).all())}
    dq_ms = time_ms(lambda: ops.flash_attention_bwd_dq(*args), flush=flush)
    dkv_ms = time_ms(lambda: ops.flash_attention_bwd_dkv(*args),
                     flush=flush)
    plain_ms = time_ms(lambda: ops._bwd_reference(*args, None),
                       flush=flush)
    # library yardstick: SDPA's backward over repeated K/V — dq, dk and
    # dv together — as one autograd.grad over a retained forward graph
    n_rep = H // kv
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k.repeat_interleave(n_rep, dim=2),
                            v.repeat_interleave(n_rep, dim=2)))
    out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        flush=flush)
    itemsize = q.element_size()
    q_bytes, kv_bytes = q.numel() * itemsize, k.numel() * itemsize
    stats = 2 * lse.numel() * 4
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    rows = []
    for name, ms, outs, n_products, bytes_moved in (
            ("flash_bwd_dq", dq_ms, ("dq",), 3,
             3 * q_bytes + 2 * kv_bytes + stats),       # q, dO, dq; k, v
            ("flash_bwd_dkv", dkv_ms, ("dk", "dv"), 4,
             2 * q_bytes + 4 * kv_bytes + stats)):      # q, dO; k, v, dk, dv
        flops = 2 * n_products * D * pairs
        bound_ms, bound_by = bound(bytes_moved, flops, dtype_name)
        err = max(errs[o]["rel"] for o in outs)
        ok = all(errs[o]["finite"] for o in outs) and err <= TOL[dtype_name]
        row = {"phase": "kernels", "kernel": name, "dtype": dtype_name,
               "shape": {"batch": B, "seq": S, "heads": H, "kv_heads": kv,
                         "head_dim": D, "causal": causal},
               "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
               "max_rel_err": err, "tol_rel": TOL[dtype_name], "ok": ok,
               "errors": {o: errs[o] for o in outs},
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "plain_covers": "dq+dk+dv", "library_covers": "dq+dk+dv",
               "k4_plus_k5_ms": dq_ms + dkv_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / ms / 1e9}
        emit(row)
        rows.append(row)
    return rows


VERIFY_PREFIXES = [0, 1, 17, 100, 333, 512, 777, 1019]
# K2 at the engine's shapes: (call site, slots, chunk rows, prefixes)
CHUNK_CASES = (("prefill_chunk", 1, 256, [768]),
               ("prefix_hit", 1, 64, [512]),
               ("verify", 8, 5, VERIFY_PREFIXES))


def check_chunk(dtype_name, case, flush, int8=False):
    """K2 (or, ``int8``, K2-i8: the prefix pages quantized from the same
    draw, the chunk's K/V in q's dtype, beside the float K2's time at the
    same shape) against its plain version at one call site."""
    import torch
    import torch.nn.functional as F
    from kubeflow_tpu_torch.compute.ops import paged_attention as ops
    site, B, S, prefixes = case
    dtype = getattr(torch, dtype_name)
    kv, n_rep, D, bs, bps = 2, 4, 128, 16, 64
    H = kv * n_rep
    g = torch.Generator().manual_seed(S)
    N = B * bps
    kc, vc = (torch.randn((N, bs, kv, D), generator=g).to("cuda", dtype)
              for _ in range(2))
    q = torch.randn((B, S, H, D), generator=g).to("cuda", dtype)
    kch, vch = (torch.randn((B, S, kv, D), generator=g).to("cuda", dtype)
                for _ in range(2))
    tables = torch.randperm(N, generator=g).reshape(B, bps).to(
        "cuda", torch.int32)
    plen = torch.tensor(prefixes, dtype=torch.int32, device="cuda")
    pages = _int8_pool((kc, vc)) if int8 else (kc, vc)
    args = (q, pages, tables, plen, kch, vch)
    kw = dict(block_size=bs, n_rep=n_rep)
    got = ops.paged_chunk_attention(*args, **kw)
    want = ops.paged_chunk_reference(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.isfinite(got.float()).all()) and err <= TOL[dtype_name]
    ms = time_ms(lambda: ops.paged_chunk_attention(*args, **kw),
                 flush=flush)
    plain_ms = time_ms(lambda: ops.paged_chunk_reference(*args, **kw),
                       flush=flush)
    # library yardstick: SDPA over the gathered prefix followed by the
    # chunk, under the two-part boolean mask (prefix columns below each
    # slot's prefix length, chunk columns causal); the gather, and an
    # int8 pool's dequant, are set-up
    P = bps * bs
    k_all, v_all = (torch.cat([p[tables.long()].reshape(B, P, kv, D), c],
                              dim=1).repeat_interleave(n_rep, dim=2)
                    .transpose(1, 2) for p, c in zip(
                        ops._dequant_kernel(pages, dtype), (kch, vch)))
    rows = torch.arange(S, device="cuda")[:, None]
    cols = torch.arange(P + S, device="cuda")[None, :]
    mask = torch.where(cols[None] < P, cols[None] < plen[:, None, None],
                       (cols - P <= rows)[None])[:, None]
    qt = q.transpose(1, 2)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, k_all, v_all, attn_mask=mask), flush=flush)
    itemsize = q.element_size()
    n_prefix = int(plen.sum())
    bytes_moved = ((2 * q.numel() + kch.numel() + vch.numel()) * itemsize
                   + _pool_bytes(pages, n_prefix)
                   + tables.numel() * 4 + plen.numel() * 4)
    flops = 4 * H * D * S * (n_prefix + B * (S + 1) / 2)
    bound_ms, bound_by = bound(bytes_moved, flops, dtype_name)
    # the grid: row tiles x kv heads x slots, times the key walk's splits
    # (bf16; fp32 walks whole)
    splits = 1 if dtype_name == "float32" else ops.chunk_splits(
        B, S, kv, n_rep, bs, bps, torch.cuda.get_device_properties(
            0).multi_processor_count)
    blocks = -(-S // (ops.CHUNK_ROW_TILE // n_rep)) * kv * B * splits
    row = {"phase": "kernels",
           "kernel": "paged_chunk_i8" if int8 else "paged_chunk",
           "dtype": dtype_name,
           "shape": {"site": site, "batch": B, "chunk": S, "heads": H,
                     "kv_heads": kv, "head_dim": D, "block_size": bs,
                     "blocks_per_slot": bps, "prefix": prefixes,
                     "splits": splits, "blocks": blocks},
           "max_abs_err": err, "tol": TOL[dtype_name], "ok": ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if int8:
        float_args = (q, (kc, vc)) + args[2:]
        row["float_kernel_ms"] = time_ms(lambda: ops.paged_chunk_attention(
            *float_args, **kw), flush=flush)
    emit(row)
    return row


MOE_SHAPE = dict(tokens=8 * 1024, top_k=2, experts=8, d=1024, ff=2816,
                 block_m=128)
# K6 at the MoE step's call sites: (site, k, n, weights read transposed)
GMM_CASES = (("gate_up", 1024, 2 * 2816, False), ("down", 2816, 1024, False),
             ("dx_gate_up", 2 * 2816, 1024, True),
             ("dx_down", 1024, 2816, True))
# K7: (site, k, n) of dw [e, k, n]
DW_CASES = (("dw_gate_up", 1024, 2 * 2816), ("dw_down", 2816, 1024))


def moe_layout(seed=0, skewed=False):
    """The MoE step's routing (8 x 1024 tokens, top-2 of 8 experts) as a
    seeded uniform draw → ``padded_group_layout`` on the card; ``skewed``:
    expert 0 takes every other row, half of them, the rest go uniformly
    to the other experts."""
    import torch
    from kubeflow_tpu_torch.compute.ops import grouped_matmul as ops
    m = MOE_SHAPE
    n = m["tokens"] * m["top_k"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if skewed:
        key = torch.randint(1, m["experts"], (n,), generator=g, device="cuda")
        key = torch.where(torch.arange(n, device="cuda") % 2 == 0, 0, key)
    else:
        key = torch.randint(0, m["experts"], (n,), generator=g, device="cuda")
    return ops.padded_group_layout(key, m["experts"], m["block_m"])


def _randn(shape, g, dtype, scale=1.0):
    import torch
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _grouped_library(fn_grouped, fn_dense, flush):
    """The yardstick: one ``torch._grouped_mm`` call with the layout's
    group offsets where the card's torch takes it for this dtype, else a
    dense ``torch.matmul`` of the same FLOPs → (ms, which)."""
    try:
        fn_grouped()
        return time_ms(fn_grouped, flush=flush, iters=10), \
            "torch._grouped_mm"
    except (RuntimeError, TypeError, AttributeError, NotImplementedError):
        return time_ms(fn_dense, flush=flush, iters=10), \
            "torch.matmul (dense, same FLOPs)"


def _gmm_row(kernel, dtype_name, shape, got, want, ms, plain_ms, lib,
             bytes_moved, flops):
    diff = float((got.float() - want.float()).abs().max())
    rel = diff / max(float(want.float().abs().max()), 1e-30)
    bound_ms, bound_by = bound(bytes_moved, flops, dtype_name)
    import torch
    row = {"phase": "kernels", "kernel": kernel, "dtype": dtype_name,
           "shape": shape, "max_abs_err": diff, "max_rel_err": rel,
           "tol_rel": TOL[dtype_name],
           "ok": bool(torch.isfinite(got.float()).all())
           and rel <= TOL[dtype_name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib[0],
           "library": lib[1], "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": flops / ms / 1e9}
    emit(row)
    return row


def check_gmm(dtype_name, case, layout, flush):
    """K6 against its plain version at one call site of the MoE step."""
    import torch
    from kubeflow_tpu_torch.compute.ops import grouped_matmul as ops
    site, k, n, trans = case
    _, be, fst, lst, m_pad = layout
    e, bm = MOE_SHAPE["experts"], MOE_SHAPE["block_m"]
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(k + n)
    x = _randn((m_pad, k), g, dtype)
    if trans:           # dx: the forward's [e, n, k] weights read as w^T
        w = _randn((e, n, k), g, dtype, k ** -0.5).transpose(1, 2)
    else:
        w = _randn((e, k, n), g, dtype, k ** -0.5)
    got = ops.grouped_matmul(x, w, be, bm)
    want = ops.grouped_matmul_reference(x, w, be, bm)
    torch.cuda.synchronize()
    ms = time_ms(lambda: ops.grouped_matmul(x, w, be, bm), flush=flush,
                 iters=10)
    plain_ms = time_ms(lambda: ops.grouped_matmul_reference(x, w, be, bm),
                       flush=flush, iters=3)
    offs = (ops.expert_tiles(be, fst, lst, e)[:, 1] * bm).to(torch.int32)
    lib = _grouped_library(lambda: torch._grouped_mm(x, w, offs=offs),
                           lambda: torch.matmul(x, w[0]), flush)
    itemsize = x.element_size()
    bytes_moved = (m_pad * k + e * k * n + m_pad * n) * itemsize \
        + be.numel() * 4
    shape = {"site": site, "rows": m_pad, "k": k, "n": n, "experts": e,
             "block_m": bm, "weights_transposed": trans}
    return _gmm_row("grouped_matmul", dtype_name, shape, got, want, ms,
                    plain_ms, lib, bytes_moved, 2 * m_pad * k * n)


def check_gmm_dw(dtype_name, case, layout, flush):
    """K7 against its plain version at one dw site of the MoE step; the
    work counted is the rows inside the experts' tile ranges."""
    import torch
    from kubeflow_tpu_torch.compute.ops import grouped_matmul as ops
    site, k, n = case
    _, be, fst, lst, m_pad = layout
    e, bm = MOE_SHAPE["experts"], MOE_SHAPE["block_m"]
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(3 * k + n)
    x = _randn((m_pad, k), g, dtype)
    dy = _randn((m_pad, n), g, dtype)
    args = (x, dy, be, fst, lst, e, bm)
    got = ops.grouped_matmul_dw(*args)
    want = ops.grouped_matmul_dw_reference(*args)
    torch.cuda.synchronize()
    ms = time_ms(lambda: ops.grouped_matmul_dw(*args), flush=flush, iters=10)
    plain_ms = time_ms(lambda: ops.grouped_matmul_dw_reference(*args),
                       flush=flush, iters=3)
    tiles = ops.expert_tiles(be, fst, lst, e)
    offs = (tiles[:, 1] * bm).to(torch.int32)
    lib = _grouped_library(lambda: torch._grouped_mm(x.t(), dy, offs=offs),
                           lambda: torch.matmul(x.t(), dy), flush)
    rows = int((tiles[:, 1] - tiles[:, 0]).sum()) * bm
    bytes_moved = rows * (k + n) * x.element_size() + e * k * n * 4 \
        + 3 * be.numel() * 4
    shape = {"site": site, "rows": m_pad, "rows_walked": rows, "k": k,
             "n": n, "experts": e, "block_m": bm}
    return _gmm_row("grouped_matmul_dw", dtype_name, shape, got, want, ms,
                    plain_ms, lib, bytes_moved, 2 * rows * k * n)


# K8 at ResNet-50's four identity-block shapes, batch 256: (H = W, C); M = C/4
BLOCK_BATCH = 256
BLOCK_SHAPES = ((56, 256), (28, 512), (14, 1024), (7, 2048))


def random_bn(ch, g, device="cuda"):
    """One BN's ``(params, stats)`` with scale, bias, mean and variance
    randomised (at init the last BN scale of a block is 0, its third
    product folds to nothing and a check would see only ``relu(x)``)."""
    import torch

    def n(scale):
        return (scale * torch.randn((ch,), generator=g)).to(device)

    return ({"scale": 1 + n(0.1), "bias": n(0.1)},
            {"mean": n(0.1), "var": 0.5 + n(1.0).abs()})


def random_block(c, m, g):
    """An identity bottleneck's ``(params, stats)`` on the card: He-normal
    convs (HWIO), every BN quantity randomised."""
    import torch
    bp, bs = {}, {}
    for i, shape in enumerate(((1, 1, c, m), (3, 3, m, m), (1, 1, m, c))):
        fan_in = shape[0] * shape[1] * shape[2]
        bp[f"conv{i}"] = (torch.randn(shape, generator=g)
                          * (2 / fan_in) ** 0.5).to("cuda")
        bp[f"bn{i}"], bs[f"bn{i}"] = random_bn(shape[-1], g)
    return bp, bs


def k8_weight_bytes(n, h, w, c, m, band, block_m, itemsize,
                    halo_inside=True, row_align=16):
    """The weight bytes one K8 launch pulls from L2: every block streams
    all of W1 [C, M] for each of phase A's row tiles and W2 [9M, M] and
    W3 [M, C] for each of phase B's and C's (``band (W + 2)`` pixels,
    rounded up to ``row_align``). ``halo_inside``: phase A's rows are the
    band's in-image rows (else the band's R + 2 rows, as the earlier
    wmma kernel computed them)."""
    b_rows = -(-band * (w + 2) // row_align) * row_align
    b_tiles = -(-b_rows // block_m)
    total = 0
    for r0 in range(0, h, band):
        a_rows = (min(r0 + band + 1, h) - max(r0 - 1, 0) if halo_inside
                  else band + 2) * w
        total += (-(-a_rows // block_m) * c * m
                  + b_tiles * (9 * m * m + m * c))
    return n * total * itemsize


def k8_kernel_name(dtype_name, tiles):
    """The K8 instantiation a plan launches, as ``ptxas_entries`` names
    it."""
    t = "bf16" if dtype_name == "bfloat16" else "float"
    return (f"fused_block_kernel<{t}, {tiles['block_m']}, "
            f"{tiles['block_n']}, {tiles['depth']}>")


def check_fused_block(dtype_name, shape, flush, ptxas):
    """K8 against its plain version at one ResNet-50 stage's identity
    block, batch 256; errors and the tolerance relative to the plain
    result's max |value|. The library yardstick is the port's unfused
    ``resnet._block(train=False)``: three cuDNN convolutions with the BN
    multiply-adds between them."""
    import torch
    from kubeflow_tpu_torch.compute.models import resnet
    from kubeflow_tpu_torch.compute.ops import fused_block as ops
    hw, c = shape
    m = c // 4
    n = BLOCK_BATCH
    dtype = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(hw * 7 + c)
    bp, bs = random_block(c, m, g)
    x = torch.randn((n, hw, hw, c), generator=g).to("cuda", dtype)
    cfg = resnet.Config(depth=50, dtype=dtype_name)
    got = ops.fused_bottleneck_eval(x, bp, bs, cfg.bn_eps)
    torch.cuda.synchronize()
    want = ops.fused_bottleneck_reference(x, bp, bs, cfg.bn_eps)
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    rel = diff / scale
    del want
    with torch.no_grad():
        lib, _ = resnet._block(x, bp, bs, cfg, 1, False)
        lib_rel = float((got.float() - lib.float()).abs().max()) / scale
        del lib
        ms = time_ms(lambda: ops.fused_bottleneck_eval(x, bp, bs, cfg.bn_eps),
                     flush=flush, iters=10)
        plain_ms = time_ms(lambda: ops.fused_bottleneck_reference(
            x, bp, bs, cfg.bn_eps), flush=flush, iters=3)
        library_ms = time_ms(lambda: resnet._block(x, bp, bs, cfg, 1, False),
                             flush=flush, iters=10)
    band_rows, smem, threads = ops.launch_plan(hw, hw, c, m, dtype)
    tiles = ops.tile_plan(hw, hw, c, m, dtype)
    ptxas = ptxas.get("fused_block", {}).get(
        k8_kernel_name(dtype_name, tiles), {})
    itemsize = x.element_size()
    pixels = n * hw * hw
    bytes_moved = (2 * pixels * c + 2 * c * m + 9 * m * m) * itemsize \
        + (2 * m + c) * 4
    flops = 2 * pixels * (2 * c * m + 9 * m * m)
    bound_ms, bound_by = bound(bytes_moved, flops, dtype_name)
    weight_bytes = k8_weight_bytes(
        n, hw, hw, c, m, band_rows, tiles["block_m"], itemsize,
        row_align=16 if dtype == torch.bfloat16 else 1)
    row = {"phase": "kernels", "kernel": "fused_block", "dtype": dtype_name,
           "shape": {"batch": n, "height": hw, "width": hw, "channels": c,
                     "bottleneck": m, "band_rows": band_rows,
                     "shared_memory_bytes": smem,
                     "block_threads": threads, **tiles},
           "registers": ptxas.get("registers"),
           "spill_stores": ptxas.get("spill_stores"),
           "l2_weight_bytes": weight_bytes,
           "l2_weight_bytes_per_ms": weight_bytes / ms,
           "max_abs_err": diff, "max_rel_err": rel,
           "tol_rel": TOL[dtype_name],
           "ok": bool(torch.isfinite(got.float()).all())
           and rel <= TOL[dtype_name],
           "vs_unfused_block_rel": lib_rel,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "resnet._block(train=False): 3 cuDNN convs + BN",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": flops / ms / 1e9}
    emit(row)
    return row


def k8_band_sweep(bands):
    """``--k8-bands``: K8's time in bf16 at every ResNet-50 stage over the
    band heights given (those that fit a block's shared memory) beside
    the height its plan chooses, each first held against the plain
    version; one JSON line a reading."""
    import torch
    from kubeflow_tpu_torch.compute.ops import fused_block as ops
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for hw, c in BLOCK_SHAPES:
        m = c // 4
        g = torch.Generator().manual_seed(hw * 7 + c)
        bp, bs = random_block(c, m, g)
        x = torch.randn((BLOCK_BATCH, hw, hw, c), generator=g).to(
            "cuda", torch.bfloat16)
        want = ops.fused_bottleneck_reference(x, bp, bs).float()
        auto = ops.launch_plan(hw, hw, c, m, x.dtype)[0]
        for band in sorted({auto} | {b for b in bands if b <= hw}):
            try:
                _, smem, threads = ops.launch_plan(hw, hw, c, m, x.dtype, band)
            except ValueError:
                continue                                 # does not fit
            got = ops.fused_bottleneck_eval(x, bp, bs, band_rows=band)
            rel = float((got.float() - want).abs().max() / want.abs().max())
            ms = time_ms(lambda: ops.fused_bottleneck_eval(
                x, bp, bs, band_rows=band), flush, iters=10)
            emit({"phase": "k8_bands", "height": hw, "channels": c,
                  "batch": BLOCK_BATCH, "dtype": "bfloat16",
                  "band_rows": band, "auto": band == auto,
                  "block_threads": threads, "shared_memory_bytes": smem,
                  **ops.tile_plan(hw, hw, c, m, x.dtype, band),
                  "ms": ms, "max_rel_err": rel})
            if not rel <= TOL["bfloat16"]:
                raise AssertionError(f"K8 disagrees at band {band}: {rel}")
        del x, want
        torch.cuda.empty_cache()


def phase_kernels(ptxas):
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        rows.append(check_paged(dtype_name, flush))
        for S in (8, 256, 300, 1024):
            rows.append(check_flash(dtype_name, S, flush))
        rows.append(check_flash(dtype_name, TRAIN_ATTN["S"], flush,
                                B=TRAIN_ATTN["B"]))
        rows += check_flash_bwd(dtype_name, flush)
        for case in CHUNK_CASES:
            rows.append(check_chunk(dtype_name, case, flush))
        # K1-i8 and K2-i8: the same shapes over int8 pages
        rows.append(check_paged(dtype_name, flush, int8=True))
        for case in CHUNK_CASES:
            rows.append(check_chunk(dtype_name, case, flush, int8=True))
    # the MoE step: K3-K5 at n_rep 1, K6 at its four sites, K7 at two
    layout = moe_layout()
    for dtype_name in ("float32", "bfloat16"):
        rows.append(check_flash(dtype_name, MOE_ATTN["S"], flush,
                                B=MOE_ATTN["B"], kv=MOE_ATTN["kv"]))
        rows += check_flash_bwd(dtype_name, flush, MOE_ATTN)
        for case in GMM_CASES:
            rows.append(check_gmm(dtype_name, case, layout, flush))
        for case in DW_CASES:
            rows.append(check_gmm_dw(dtype_name, case, layout, flush))
    # K1 and K1-i8 over a lone 1024-token slot (the longest walk alone),
    # side rows kept out of the kernels line
    lone = [check_paged("bfloat16", flush, int8=i8, lengths=[1024])
            for i8 in (False, True)]
    rows += [dict(r, side_row=True) for r in lone]
    # K6 and K7 under routing skew, side rows kept out of the kernels line
    skewed_layout = moe_layout(skewed=True)
    skewed = [check_gmm("bfloat16", ("gate_up_skewed", 1024, 2 * 2816,
                                     False), skewed_layout, flush),
              check_gmm_dw("bfloat16", ("dw_gate_up_skewed", 1024, 2 * 2816),
                           skewed_layout, flush)]
    rows += [dict(r, side_row=True) for r in skewed]
    del layout, skewed_layout
    torch.cuda.empty_cache()
    # the BERT step: K3-K5 without a causal mask at head_dim 64; the
    # ResNet-50 eval path: K8 at its four stages
    for dtype_name in ("float32", "bfloat16"):
        rows.append(check_flash(dtype_name, BERT_ATTN["S"], flush,
                                B=BERT_ATTN["B"], kv=BERT_ATTN["kv"],
                                H=BERT_ATTN["H"], D=BERT_ATTN["D"],
                                causal=False))
        rows += check_flash_bwd(dtype_name, flush, BERT_ATTN)
        for shape in BLOCK_SHAPES:
            rows.append(check_fused_block(dtype_name, shape, flush, ptxas))
            torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    return rows


def flagship_config(dtype="bfloat16", attention="flash", **kw):
    """The bench-LM flagship at full width (bench.py's LM config)."""
    from kubeflow_tpu_torch.compute.models import transformer
    fields = dict(vocab_size=32768, d_model=1024, n_layers=12, n_heads=8,
                  n_kv_heads=2, max_seq=1024)
    return transformer.Config(**{**fields, **kw}, dtype=dtype,
                              attention=attention)


PROMPT_LENS = (7, 64, 200, 300, 700)
MAX_TOKENS = (8, 32, 64)


def requests(n, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, PROMPT_LENS[i % 5]).tolist(),
             MAX_TOKENS[i % 3]) for i in range(n)]


def _serve(eng, reqs, kernel_fns):
    """Warm ``eng`` up, set every launch count to 0, submit ``reqs``
    together and wait for all → (outs, handles, wall s, stats before,
    stats after)."""
    eng.generate([1, 2, 3], max_tokens=2)        # warm-up
    for fn in kernel_fns.values():
        fn.launches = 0
    s0 = dict(eng.stats)
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_tokens=m) for p, m in reqs]
    outs = [h.result(timeout=600) for h in handles]
    return outs, handles, time.perf_counter() - t0, s0, dict(eng.stats)


def _serving_row(phase, reqs, outs, handles, wall, s0, s1):
    """The serving numbers of one run of ``_serve``."""
    steps = s1["decode_steps"] - s0["decode_steps"]
    n_tokens = sum(len(o) for o, _ in outs)
    ttft = sorted(h.ttft_s for h in handles)
    return {"phase": phase, "dtype": "bfloat16", "requests": len(reqs),
            "slots": 8, "tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            "ttft_p50_ms": 1e3 * statistics.median(ttft),
            "ttft_max_ms": 1e3 * ttft[-1],
            "decode_steps": steps,
            "decode_step_ms": 1e3 * (s1["decode_seconds_total"]
                                     - s0["decode_seconds_total"]) / steps,
            "prefills": s1["prefills"] - s0["prefills"],
            "prefill_ms_mean": 1e3 * (s1["prefill_seconds_total"]
                                      - s0["prefill_seconds_total"])
                               / (s1["prefills"] - s0["prefills"]),
            "peak_occupancy": s1["peak_occupancy"]}


def _pool_split(eng):
    """(page bytes, scale bytes) of an engine's KV pool."""
    pool = eng._cache
    return (sum(p.numel() * p.element_size() for p in pool[:2]),
            sum(p.numel() * p.element_size() for p in pool[2:]))


def phase_engine(params, kernel_fns):
    """The main path: bf16 flagship engine serving 12 concurrent
    requests plus one full-width ``transformer.apply``. Launch counts
    are zeroed just before and read just after."""
    import torch
    from kubeflow_tpu_torch.compute import generate as gen_lib
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = flagship_config()
    eng = gen_lib.GenerationEngine(params, cfg, max_slots=8, block_size=16,
                                   max_context=1024, name="flagship")
    reqs = requests(12, cfg.vocab_size)
    try:
        outs, handles, wall, s0, s1 = _serve(eng, reqs, kernel_fns)
        toks = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq),
                             generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            logits = transformer.apply(params, toks.cuda(), cfg)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernel_fns.items()}
        pool_bytes = _pool_split(eng)[0]
    finally:
        eng.close()
    _check_served(reqs, outs, cfg.vocab_size)
    if logits.shape != (1, cfg.max_seq, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"apply gave {tuple(logits.shape)} logits "
                             f"or non-finite values")
    with torch.no_grad():
        logits32 = transformer.apply(
            params, toks.cuda(), flagship_config("float32", "dense"))
    apply_err = float((logits - logits32).abs().max())
    if not torch.allclose(logits, logits32, atol=0.2, rtol=0.1):
        raise AssertionError(f"bf16 flash apply vs fp32 dense apply: max "
                             f"|d| {apply_err} outside atol 0.2 rtol 0.1")
    row = {**_serving_row("engine", reqs, outs, handles, wall, s0, s1),
           "apply_vs_fp32_max_abs": apply_err, "pool_page_bytes": pool_bytes,
           "launches": launches}
    emit(row)
    _require(launches, ("paged_decode", "flash_fwd"), "plain engine")
    return row


def phase_engine_i8(params, kernel_fns, float_row):
    """The int8 pool on the main path: ``phase_engine``'s 12 requests
    over 8 slots on a ``kv_dtype="int8"`` engine, beside the bf16
    engine's tokens/s and decode-step ms from this run. Its decode reads
    go through K1-i8, never K1; its page bytes are half the bf16 pool's."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    cfg = flagship_config()
    eng = gen_lib.GenerationEngine(params, cfg, max_slots=8, block_size=16,
                                   max_context=1024, kv_dtype="int8",
                                   name="flagship-int8")
    reqs = requests(12, cfg.vocab_size)
    try:
        outs, handles, wall, s0, s1 = _serve(eng, reqs, kernel_fns)
        launches = {name: fn.launches for name, fn in kernel_fns.items()}
        page_bytes, scale_bytes = _pool_split(eng)
        snap = eng.snapshot()
    finally:
        eng.close()
    _check_served(reqs, outs, cfg.vocab_size)
    row = {**_serving_row("engine_i8", reqs, outs, handles, wall, s0, s1),
           "kv_dtype": snap["kv_dtype"], "pool_page_bytes": page_bytes,
           "pool_scale_bytes": scale_bytes,
           "bf16_pool_page_bytes": float_row["pool_page_bytes"],
           "attn_bytes_read": s1["attn_bytes_read"] - s0["attn_bytes_read"],
           "bf16_tokens_per_s": float_row["tokens_per_s"],
           "bf16_decode_step_ms": float_row["decode_step_ms"],
           "launches": launches}
    emit(row)
    if snap["kv_dtype"] != "int8" or 2 * page_bytes \
            != float_row["pool_page_bytes"]:
        raise AssertionError(f"int8 pool page bytes {page_bytes} are not "
                             f"half of bf16's {float_row['pool_page_bytes']}")
    _require(launches, ("paged_decode_i8", "flash_fwd"), "int8 engine")
    _refuse(launches, ("paged_decode", "paged_chunk"), "int8 engine")
    return row


def _require(launches, names, path):
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{missing}")


def _refuse(launches, names, path):
    """The float pool reads must not run on an int8 path."""
    ran = [n for n in names if launches[n] != 0]
    if ran:
        raise AssertionError(f"float pool kernels launched on the {path} "
                             f"path: {ran}")


def _check_served(reqs, outs, vocab):
    for (prompt, m), (out, reason) in zip(reqs, outs):
        if reason != "length" or len(out) != m \
                or not all(0 <= t < vocab for t in out):
            raise AssertionError(f"request of {len(prompt)} prompt tokens "
                                 f"ended {reason!r} with {len(out)} of "
                                 f"{m} tokens")


COHORT_PREFIX = 512
COHORT_SUFFIXES = (16, 40, 100, 200)     # the first is each cohort's lead


def cohort_requests(vocab, budget=32, seed=3):
    """3 cohorts x 4 prompts sharing a 512-token prefix, and two cold
    900-token prompts → (leads, rest, cold), each a list of
    ``(prompt, max_tokens)``."""
    rng = np.random.default_rng(seed)
    cohorts = []
    for _ in range(3):
        prefix = rng.integers(0, vocab, COHORT_PREFIX).tolist()
        cohorts.append([(prefix + rng.integers(0, vocab, n).tolist(), budget)
                        for n in COHORT_SUFFIXES])
    leads = [c[0] for c in cohorts]
    rest = [r for c in cohorts for r in c[1:]]
    cold = [(rng.integers(0, vocab, 900).tolist(), 64) for _ in range(2)]
    return leads, rest, cold


def phase_prefix(params, kernel_fns, kv_dtype=None):
    """The prefix + chunked path: bf16 flagship, ``prefix_cache=True``,
    ``prefill_chunk=256``. Each cohort's lead runs first (its prompt
    enters the trie only at its last chunk), then the other 9 cohort
    requests beside two cold 900-token prompts. ``kv_dtype="int8"``
    (phase ``prefix_i8``): the same traffic on an int8 pool, read by
    K2-i8 and K1-i8 and never by the float K1/K2."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    cfg = flagship_config()
    phase = "prefix_i8" if kv_dtype else "prefix"
    eng = gen_lib.GenerationEngine(params, cfg, max_slots=8, block_size=16,
                                   max_context=1024, prefill_chunk=256,
                                   kv_dtype=kv_dtype, name=phase)
    leads, rest, cold = cohort_requests(cfg.vocab_size)
    try:
        eng.generate([1, 2, 3], max_tokens=2)        # warm-up
        for fn in kernel_fns.values():
            fn.launches = 0
        s0 = dict(eng.stats)
        t0 = time.perf_counter()
        lead_handles = [eng.submit(p, max_tokens=m) for p, m in leads]
        outs = [h.result(timeout=600) for h in lead_handles]
        handles = [eng.submit(p, max_tokens=m) for p, m in rest + cold]
        outs += [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        d = {k: eng.stats[k] - s0[k] for k in s0}
        launches = {name: fn.launches for name, fn in kernel_fns.items()}
        snap = eng.snapshot()
    finally:
        eng.close()
    reqs = leads + rest + cold
    _check_served(reqs, outs, cfg.vocab_size)
    handles = lead_handles + handles
    ttft = sorted(h.ttft_s for h in handles)
    n_tokens = sum(len(o) for o, _ in outs)
    prefills = d["prefills"]
    row = {"phase": phase, "dtype": "bfloat16", "requests": len(reqs),
           "kv_dtype": snap["kv_dtype"],
           "slots": 8, "prefill_chunk": 256, "tokens": n_tokens,
           "wall_s": wall, "tokens_per_s": n_tokens / wall,
           "ttft_p50_ms": 1e3 * statistics.median(ttft),
           "ttft_max_ms": 1e3 * ttft[-1],
           "prefills": prefills,
           "prefill_chunks": d["prefill_chunks"],
           "prefill_ms_mean": 1e3 * d["prefill_seconds_total"]
                              / prefills,
           "prefix_hits": d["prefix_hits"],
           "prefix_misses": d["prefix_misses"],
           "prefix_tokens_skipped": d["prefix_tokens_skipped"],
           "decode_steps": d["decode_steps"],
           "decode_step_ms": 1e3 * d["decode_seconds_total"]
                             / d["decode_steps"],
           "cached_blocks": snap["prefix_cache"]["cached_blocks"],
           "launches": launches}
    emit(row)
    if row["prefix_hits"] < 9:
        raise AssertionError(f"{row['prefix_hits']} prefix hits, want >= 9")
    if row["prefill_chunks"] <= prefills:
        raise AssertionError(f"{row['prefill_chunks']} prefill chunks for "
                             f"{prefills} prefills: nothing was chunked")
    if kv_dtype:
        _require(launches, ("paged_chunk_i8", "paged_decode_i8"),
                 "int8 prefix + chunked")
        _refuse(launches, ("paged_chunk", "paged_decode"),
                "int8 prefix + chunked")
    else:
        _require(launches, ("paged_chunk", "paged_decode"),
                 "prefix + chunked")
    return row


def spec_pair(params, cfg):
    """The flagship with layers 2.. dampened by 0.02, and its first 2
    layers as the draft → (target, draft, draft config)."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    return gen_lib.truncated_draft(params, cfg, 2, dampen=0.02)


def phase_spec(target, draft, dcfg, kernel_fns):
    """The speculative path: ``spec_k=4`` over the ``requests(8)`` mix."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    cfg = flagship_config()
    eng = gen_lib.GenerationEngine(target, cfg, max_slots=8, block_size=16,
                                   max_context=1024, draft_params=draft,
                                   draft_config=dcfg, spec_k=4,
                                   name="speculative")
    reqs = requests(8, cfg.vocab_size)
    try:
        eng.generate([1, 2, 3], max_tokens=6)        # warm-up
        for fn in kernel_fns.values():
            fn.launches = 0
        s0 = dict(eng.stats)
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_tokens=m) for p, m in reqs]
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        d = {k: eng.stats[k] - s0[k] for k in s0}
        launches = {name: fn.launches for name, fn in kernel_fns.items()}
    finally:
        eng.close()
    _check_served(reqs, outs, cfg.vocab_size)
    n_tokens = sum(len(o) for o, _ in outs)
    proposed = d["spec_proposed"]
    rounds = d["spec_rounds"]
    ttft = sorted(h.ttft_s for h in handles)
    row = {"phase": "speculative", "dtype": "bfloat16", "requests": len(reqs),
           "slots": 8, "spec_k": 4, "draft_layers": dcfg.n_layers,
           "tokens": n_tokens, "wall_s": wall,
           "tokens_per_s": n_tokens / wall,
           "ttft_p50_ms": 1e3 * statistics.median(ttft),
           "rounds": rounds, "proposed": proposed,
           "accepted": d["spec_accepted"],
           "acceptance": d["spec_accepted"] / proposed
           if proposed else None,
           "round_ms": 1e3 * d["decode_seconds_total"]
                       / max(1, d["decode_steps"]),
           "launches": launches}
    emit(row)
    _require(launches, ("paged_chunk", "flash_fwd"), "speculative")
    return row


def _engine_logits(params, cfg, reqs, kv_dtype=None):
    from kubeflow_tpu_torch.compute import generate as gen_lib
    eng = gen_lib.GenerationEngine(params, cfg, max_slots=8, block_size=16,
                                   max_context=1024, prefix_cache=False,
                                   debug_logits=True, kv_dtype=kv_dtype,
                                   name=f"conformance-{cfg.dtype}")
    try:
        handles = [eng.submit(p, max_tokens=m) for p, m in reqs]
        return [(h.result(timeout=600)[0], h.logits) for h in handles]
    finally:
        eng.close()


def phase_conformance(params):
    """fp32 engine vs the cache-free fp32 oracle through dense
    attention (kernels and oracle independent): tokens identical,
    logits within atol 1e-3 / rtol 1e-3; a token mismatch passes only
    where the oracle's top-2 gap at that step is below 1e-3. bf16
    engine logits within 0.2 / 0.1 of the same oracle, up to the first
    step where its tokens leave the oracle's; so the fp32 engine on an
    int8 pool within 0.08 / 0.05 (JAX's int8 envelope,
    ``tests/test_compute_generate.py:1090``), and off the oracle by more
    than fp32 noise (max |Δ| > 1e-5)."""
    from kubeflow_tpu_torch.compute import conformance
    from kubeflow_tpu_torch.compute import generate as gen_lib
    cfg32 = flagship_config("float32")
    oracle_cfg = flagship_config("float32", "dense")
    reqs = requests(4, cfg32.vocab_size)
    oracle = [gen_lib.reference_greedy_decode(params, oracle_cfg, p, m,
                                              collect_logits=True)
              for p, m in reqs]
    report = {"phase": "conformance", "requests": len(reqs),
              "fp32": [], "bf16": [], "int8_fp32": []}
    for key, dtype, kv_dtype, atol, rtol in (
            ("fp32", "float32", None, 1e-3, 1e-3),
            ("bf16", "bfloat16", None, 0.2, 0.1),
            ("int8_fp32", "float32", "int8", 0.08, 0.05)):
        got = _engine_logits(params, flagship_config(dtype), reqs, kv_dtype)
        for (toks, logits), (want, rows) in zip(got, oracle):
            n = next((i for i, (a, b) in enumerate(zip(toks, want))
                      if a != b), len(want))
            entry = {"steps": len(want), "first_mismatch": None}
            if n < len(want):
                top2 = np.sort(rows[n])[-2:]
                gap = float(top2[1] - top2[0])
                entry["first_mismatch"] = {"step": n, "oracle_top2_gap": gap}
                if key == "fp32" and gap >= atol:
                    raise AssertionError(
                        f"fp32 engine token {n} differs from the oracle "
                        f"where the oracle's top-2 gap is {gap}")
            div = conformance.assert_logits_close(
                logits[:n + 1], rows[:n + 1], atol=atol, rtol=rtol,
                what=f"{dtype} engine vs fp32 oracle")
            entry.update(max_abs=div["atol"], max_rel=div["rtol"],
                         compared=div["steps"])
            report[key].append(entry)
    emit(report)
    lossy = max(e["max_abs"] for e in report["int8_fp32"])
    if not lossy > 1e-5:
        raise AssertionError(f"the int8 pool's logits sit {lossy} from the "
                             f"fp32 oracle: the int8 path was not taken")
    return report


def _served(eng, batches):
    """Submit each batch of ``(prompt, max_tokens)`` together, the next
    after the last finished → the generated tokens, in order."""
    out = []
    for batch in batches:
        handles = [eng.submit(p, max_tokens=m) for p, m in batch]
        out += [h.result(timeout=600)[0] for h in handles]
    return out


def _agreement(got, want, rows=None, tol=1e-3):
    """Per request: the first step where ``got`` leaves ``want``, and the
    plain engine's top-2 logit gap there (``rows`` given). A mismatch
    at a gap of ``tol`` or more raises."""
    report = []
    for i, (a, b) in enumerate(zip(got, want)):
        n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
        entry = {"steps": len(b), "first_mismatch": n}
        if n is not None and rows is not None:
            top2 = np.sort(rows[i][n])[-2:]
            entry["plain_top2_gap"] = gap = float(top2[1] - top2[0])
            if gap >= tol:
                raise AssertionError(f"request {i}: token {n} differs from "
                                     f"the plain engine's, whose top-2 gap "
                                     f"there is {gap}")
        report.append(entry)
    return report


def phase_identity(params, target, draft, dcfg):
    """fp32 tokens of the prefix/chunked engine and of the speculative
    engine against the plain engine (``prefix_cache=False``, monolithic
    prefill, ``debug_logits`` for the top-2 gaps), 4 short requests each
    at full width, and of the speculative engine on an int8 pool against
    the plain engine on an int8 pool; bf16 agreement printed only."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    kw = dict(max_slots=8, block_size=16, max_context=1024)
    leads, rest, cold = cohort_requests(32768, budget=8)
    prefix_batches = [[leads[0]], [rest[0], rest[1], (cold[0][0], 8)]]
    spec_reqs = [(p, min(m, 16)) for p, m in requests(4, 32768)]
    report = {"phase": "identity"}
    for dtype in ("float32", "bfloat16"):
        cfg = flagship_config(dtype)
        spec = dict(draft_params=draft, spec_k=4,
                    draft_config=dataclasses.replace(dcfg, dtype=dtype))
        for path, model, batches, kv_dtype, extra in (
                ("prefix", params, prefix_batches, None,
                 dict(prefill_chunk=256)),
                ("speculative", target, [spec_reqs], None, spec),
                ("speculative_int8", target, [spec_reqs], "int8", spec)):
            flat = [r for b in batches for r in b]
            eng = gen_lib.GenerationEngine(model, cfg, name=f"{path}-{dtype}",
                                           kv_dtype=kv_dtype, **kw, **extra)
            try:
                got = _served(eng, batches)
                hits = eng.stats["prefix_hits"]
            finally:
                eng.close()
            plain = gen_lib.GenerationEngine(
                model, cfg, prefix_cache=False, name=f"plain-{dtype}",
                debug_logits=dtype == "float32", kv_dtype=kv_dtype, **kw)
            try:
                handles = [plain.submit(p, max_tokens=m) for p, m in flat]
                want = [h.result(timeout=600)[0] for h in handles]
                rows = [h.logits for h in handles] \
                    if dtype == "float32" else None
            finally:
                plain.close()
            entries = _agreement(got, want, rows)
            same = sum(x == y for a, b in zip(got, want)
                       for x, y in zip(a, b))
            report[f"{path}_{dtype}"] = {
                "requests": len(flat), "tokens_equal": same,
                "tokens": sum(len(b) for b in want),
                "prefix_hits": hits, "per_request": entries}
    emit(report)
    if report["prefix_float32"]["prefix_hits"] < 2:
        raise AssertionError("the fp32 prefix identity run had no hits")
    return report


WIRE_MODEL = "flagship"


def _wire_stream(port, prompt, max_tokens, model, start=None, headers=None):
    """One keep-alive client: ``GET /healthz``, wait at ``start`` (a
    barrier), then ``POST`` one ``:generate`` (with ``headers``, e.g.
    ``X-Tenant``) on the same connection and read the stream frame by
    frame → dict of the status, the head, the frames (or the error
    body), the seconds to the first token frame and to the end, on the
    client's clock."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", "/healthz")
        conn.getresponse().read()
        if start is not None:
            start.wait()
        t0 = time.perf_counter()
        conn.request("POST", f"/v1/models/{model}:generate",
                     json.dumps({"tokens": prompt,
                                 "max_tokens": max_tokens}).encode(),
                     {"Content-Type": "application/json",
                      **(headers or {})})
        resp = conn.getresponse()
        out = {"status": resp.status, "max_tokens": max_tokens,
               "head": {k.lower(): v for k, v in resp.getheaders()},
               "first_frame_s": None}
        if resp.status != 200:
            out["error"] = resp.read().decode()
            return out
        frames = []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.strip():
                frames.append(json.loads(line))
                if out["first_frame_s"] is None:
                    out["first_frame_s"] = time.perf_counter() - t0
        out["frames"] = frames
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        conn.close()


def _wire_clients(port, reqs, model, headers=None):
    """``len(reqs)`` keep-alive clients POST together, client i with
    ``headers[i]`` → (their results in request order, wall seconds from
    the start to the last frame)."""
    import threading
    start = threading.Barrier(len(reqs) + 1)
    results = [None] * len(reqs)
    headers = headers or [None] * len(reqs)

    def client(i, prompt, m):
        try:
            results[i] = _wire_stream(port, prompt, m, model, start,
                                      headers[i])
        except Exception as e:  # noqa: BLE001 — reported by _check_wire
            results[i] = {"status": None, "error": repr(e)}

    threads = [threading.Thread(target=client, args=(i, p, m))
               for i, (p, m) in enumerate(reqs)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=900)
    return results, time.perf_counter() - t0


def _check_wire(results, vocab):
    """Every stream 200 NDJSON, token frames with contiguous indices,
    the done frame's tokens the streamed ones (plain ints, each budget
    spent unless EOS came first) and ``X-TTFT-Ms`` the done frame's
    ``ttft_s`` x 1000 → the streamed tokens."""
    out = []
    for i, r in enumerate(results):
        if r["status"] != 200 or r["head"].get("content-type") \
                != "application/x-ndjson":
            raise AssertionError(f"stream {i}: {r['status']} "
                                 f"{r.get('error') or r['head']}")
        frames = r["frames"]
        toks = [f for f in frames if "token" in f]
        done = frames[-1]
        streamed = [f["token"] for f in toks]
        if [f["index"] for f in toks] != list(range(len(toks))) \
                or not done.get("done") or done["tokens"] != streamed \
                or len(toks) + 1 != len(frames):
            raise AssertionError(f"stream {i}: broken frames {frames}")
        if not all(type(t) is int and 0 <= t < vocab for t in streamed):
            raise AssertionError(f"stream {i}: tokens {streamed}")
        if not (done["reason"] == "eos"
                or (done["reason"] == "length"
                    and len(streamed) == r["max_tokens"])):
            raise AssertionError(f"stream {i} ended {done['reason']!r} "
                                 f"with {len(streamed)} of "
                                 f"{r['max_tokens']} tokens")
        if r["head"].get("x-ttft-ms") \
                != repr(round(done["ttft_s"] * 1000, 3)):
            raise AssertionError(f"stream {i}: X-TTFT-Ms "
                                 f"{r['head'].get('x-ttft-ms')} != done "
                                 f"ttft_s {done['ttft_s']} x 1000")
        out.append(streamed)
    return out


def _wire_numbers(results, wall):
    """tokens/s over the wall, TTFT p50/max and ITG p50 from the done
    frames, and the client's own time to the first frame."""
    dones = [r["frames"][-1] for r in results]
    n = sum(len(d["tokens"]) for d in dones)
    ttft = sorted(d["ttft_s"] for d in dones)
    itg = [d["itg_p50_s"] for d in dones if d["itg_p50_s"] is not None]
    return {"tokens": n, "wall_s": wall, "tokens_per_s": n / wall,
            "ttft_p50_ms": 1e3 * statistics.median(ttft),
            "ttft_max_ms": 1e3 * ttft[-1],
            "itg_p50_ms": 1e3 * statistics.median(itg),
            "itg_max_ms": 1e3 * max(d["itg_max_s"] for d in dones
                                    if d["itg_max_s"] is not None),
            "client_first_frame_p50_ms": 1e3 * statistics.median(
                r["first_frame_s"] for r in results)}


#: the serving transports every wire phase runs over, in this order
#: (``hack/transport_smoke.py --reverse`` flips it)
TRANSPORTS = ("threaded", "async")


def _wire_run(eng, reqs, kernel_fns, transport="threaded"):
    """Serve ``eng`` on the port's ``ModelServer`` (127.0.0.1, port 0,
    ``transport``), warm it over HTTP, zero the launch counts, let
    ``len(reqs)`` clients stream ``reqs`` together, read the counts;
    right after, the same engine serves the same ``reqs`` in-process
    through ``submit``. The server (and with it the engine) stops at the
    end → dict."""
    from kubeflow_tpu_torch.compute import serving
    server = serving.ModelServer()
    server.register_generator(WIRE_MODEL, eng)
    try:
        port = server.start(port=0, host="127.0.0.1", transport=transport)
        warm = _wire_stream(port, [1, 2, 3], 2, WIRE_MODEL)
        if warm["status"] != 200:
            raise AssertionError(f"warm-up stream: {warm}")
        for fn in kernel_fns.values():
            fn.launches = 0
        s0 = dict(eng.stats)
        results, wall = _wire_clients(port, reqs, WIRE_MODEL)
        launches = {name: fn.launches for name, fn in kernel_fns.items()}
        s1 = dict(eng.stats)
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_tokens=m) for p, m in reqs]
        outs = [h.result(timeout=600) for h in handles]
        wall_in = time.perf_counter() - t0
        s2 = dict(eng.stats)
    finally:
        server.stop()
    return {"results": results, "wall": wall, "launches": launches,
            "outs": outs, "wall_in": wall_in,
            "d_wire": {k: s1[k] - s0[k] for k in s0},
            "d_in": {k: s2[k] - s1[k] for k in s1}}


def _first_mismatches(got, want):
    """Per request, the first step where ``got`` leaves ``want`` (None
    where they agree)."""
    return [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
            for a, b in zip(got, want)]


WIRE_RATIO_KEYS = ("tokens_per_s", "ttft_p50_ms", "itg_p50_ms",
                   "decode_step_ms", "client_first_frame_p50_ms")


def transport_ratios(rows, keys):
    """The async row's numbers over the threaded row's, measured in one
    call → ``{"order": the transports in run order, metric: async /
    threaded}``; a key is a path of nested keys (``"images_per_s.binary"``)."""
    def get(row, key):
        for k in key.split("."):
            row = row[k]
        return row

    out = {"order": list(rows)}
    out.update({k: get(rows["async"], k) / get(rows["threaded"], k)
                for k in keys if get(rows["threaded"], k)})
    return out


def wire_row(transport, run, identity):
    """One ``wire`` row: the transport, the streams' numbers beside the
    in-process run's, the decode step on each side, the identity verdict
    and the launches."""
    d, d_in = run["d_wire"], run["d_in"]
    row = {"phase": "wire", "dtype": "bfloat16",
           "requests": len(run["results"]), "slots": 8,
           "clients": len(run["results"]), "transport": transport,
           **_wire_numbers(run["results"], run["wall"]),
           "decode_steps": d["decode_steps"],
           "decode_step_ms": 1e3 * d["decode_seconds_total"]
                             / d["decode_steps"],
           "prefills": d["prefills"],
           "inproc_tokens_per_s": sum(len(o) for o, _ in run["outs"])
                                  / run["wall_in"],
           "inproc_decode_steps": d_in["decode_steps"],
           "inproc_decode_step_ms": 1e3 * d_in["decode_seconds_total"]
                                    / d_in["decode_steps"],
           "identity": identity, "launches": run["launches"]}
    return row


def phase_wire(params, kernel_fns):
    """The flagship streamed over HTTP, once over each transport
    (``TRANSPORTS``): a fresh bf16 engine (8 slots, the paged backend,
    the prefix cache on) behind the port's ``ModelServer``; 12 keep-alive
    clients POST ``requests(12)`` to ``:generate`` together. Every stream
    is checked (``_check_wire``), K1 and K3 must launch, and the streamed
    tokens must equal what the same engine gives the same requests
    in-process right after. That run meets the prefix cache the wire run
    filled, so its first tokens come from K2 over cached pages instead of
    K3: where bf16 rounding makes the two differ, the same comparison
    runs in fp32 at full width over the same transport, where they must
    agree. A ``wire_transports`` row then gives the async numbers over the
    threaded ones. → {transport: row}"""
    import torch
    from kubeflow_tpu_torch.compute import generate as gen_lib
    kw = dict(max_slots=8, block_size=16, max_context=1024)
    cfg = flagship_config()
    reqs = requests(12, cfg.vocab_size)
    rows = {}
    for transport in TRANSPORTS:
        tag = "" if transport == "threaded" else f"-{transport}"
        run = _wire_run(gen_lib.GenerationEngine(
            params, cfg, name=f"wire{tag}", **kw), reqs, kernel_fns,
            transport)
        torch.cuda.empty_cache()
        streamed = _check_wire(run["results"], cfg.vocab_size)
        _check_served(reqs, run["outs"], cfg.vocab_size)
        inproc = [o for o, _ in run["outs"]]
        identity = {"bfloat16": {
            "equal": streamed == inproc,
            "first_mismatch": _first_mismatches(streamed, inproc),
            "inproc_prefix_hits": run["d_in"]["prefix_hits"]}}
        if streamed != inproc:
            run32 = _wire_run(gen_lib.GenerationEngine(
                params, flagship_config("float32"),
                name=f"wire-fp32{tag}", **kw), reqs, {}, transport)
            torch.cuda.empty_cache()
            s32 = _check_wire(run32["results"], cfg.vocab_size)
            in32 = [o for o, _ in run32["outs"]]
            identity["float32"] = {
                "equal": s32 == in32,
                "first_mismatch": _first_mismatches(s32, in32),
                "inproc_prefix_hits": run32["d_in"]["prefix_hits"]}
        row = wire_row(transport, run, identity)
        emit(row)
        _require(run["launches"], ("paged_decode", "flash_fwd"),
                 f"wire ({transport})")
        if not identity.get("float32", identity["bfloat16"])["equal"]:
            raise AssertionError(
                f"tokens streamed over the {transport} transport differ "
                f"from the same engine's in-process tokens: {identity}")
        rows[transport] = row
    emit({"phase": "wire_transports", "async_over_threaded":
          transport_ratios(rows, WIRE_RATIO_KEYS)})
    return rows


#: the two tenants of the QoS phases and of ``wire_cmd``'s ledger (no
#: rates: unconstrained)
QOS_TENANTS = {"crawler": {"class": "batch"},
               "acme": {"class": "interactive"}}

#: the flagship's width under the JAX entry's knobs (no KV-head knob:
#: the model is MHA), 8 slots, 256-token prefill chunks, the tenants'
#: ledger
WIRE_CMD_ENV = {"MODEL_GENERATE": "1", "PORT": "0", "HOST": "127.0.0.1",
                "GEN_VOCAB": "32768", "GEN_D_MODEL": "1024",
                "GEN_LAYERS": "12", "GEN_HEADS": "8",
                "GEN_MAX_CONTEXT": "1024", "GEN_DTYPE": "bfloat16",
                "GEN_SLOTS": "8", "GEN_PREFILL_CHUNK": "256",
                "QOS_TENANTS": json.dumps(QOS_TENANTS),
                "OBS_EXPORT_DIR": ""}
#: the tenant of each of ``wire_cmd``'s 4 streams
WIRE_CMD_TENANTS = ("crawler", "acme", "crawler", "acme")
#: the transport of ``wire_cmd``'s first replica, as the ModelDeployment
#: controller renders every replica; the decode-role one stays threaded
WIRE_CMD_TRANSPORT = "async"
WIRE_CMD_DEVICE = "cuda:0"


def _http(port, method, path, body=None):
    """One request on a fresh connection → (status, head, body bytes)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                resp.read())
    finally:
        conn.close()


def _check_qos_classes(results, tenants):
    """Each stream's ``X-QoS-Class`` and done-frame ``qos`` view name
    its tenant and the class ``QOS_TENANTS`` gives it."""
    for i, (r, tenant) in enumerate(zip(results, tenants)):
        cls = QOS_TENANTS[tenant]["class"]
        qos = r["frames"][-1].get("qos") or {}
        if r["head"].get("x-qos-class") != cls \
                or (qos.get("tenant"), qos.get("class")) != (tenant, cls):
            raise AssertionError(
                f"stream {i} of tenant {tenant!r}: X-QoS-Class "
                f"{r['head'].get('x-qos-class')!r}, done qos {qos}, "
                f"want class {cls!r}")


def _qos_tokens(metrics_text):
    """``serving_qos_tokens_total`` by (tenant, class) from a
    ``/metrics`` exposition."""
    return {(t, c): float(v) for t, c, v in re.findall(
        r'^serving_qos_tokens_total\{tenant="([^"]*)",class="([^"]*)"\} '
        r'(\S+)$', metrics_text, re.M)}


class _Replica:
    """A ``model-server`` subprocess whose output a thread reads; ``port()``
    waits for its ``PORT n`` line."""

    def __init__(self, env, root):
        import queue
        import subprocess
        import threading
        self.lines, self.log = queue.Queue(), []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.cmd", "model-server"],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for ln in self.proc.stdout:
            self.log.append(ln.rstrip())
            self.lines.put(ln)
        self.lines.put(None)

    def port(self):
        while True:
            ln = self.lines.get(timeout=300)
            if ln is None:
                raise AssertionError(f"model-server exited "
                                     f"{self.proc.wait()} before PORT: "
                                     f"{self.log}")
            if ln.startswith("PORT "):
                return int(ln.split()[1])

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def check_transport_log(log, transport):
    """A replica's startup log must name the transport it serves on."""
    if not any(f"({transport} transport)" in ln for ln in log):
        raise AssertionError(f"the replica's log does not name the "
                             f"{transport} transport: {log[-10:]}")


def phase_wire_cmd():
    """``python -m kubeflow_tpu_torch.cmd model-server`` as a subprocess
    under ``WIRE_CMD_ENV`` and ``SERVING_TRANSPORT=async`` (its log names
    the transport): read ``PORT n``; ``/healthz`` answers ok,
    ``/v1/models/default`` names ``cuda:0``; one first request, timed
    alone (the replica's first launches); 4 requests (one a
    700-token prompt) stream together, two as tenant ``crawler`` and two
    as ``acme``, with more prefill chunks than prefills (chunked prefill
    on K2) and each ``X-QoS-Class`` its tenant's ledger class;
    ``/metrics`` counts generated tokens, and tokens of both tenants
    under ``serving_qos_tokens_total``; one two-hop request, ``:prefill``
    on it and ``:attach`` on a second replica started with
    ``GEN_ROLE=decode`` (``check_hop``; the second replica's snapshot
    names its role and one import, no prefill); after ``POST
    /admin/drain`` a ``:generate`` answers 503; and SIGTERM ends both
    processes with 0 within 30 s."""
    import os
    import pathlib
    import signal
    root = pathlib.Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GEN_") and k not in (
               "MODEL_MODULE", "MODEL_DEVICE_MS", "QOS_TENANTS",
               "SERVING_TRANSPORT", "MODEL_NAME")}
    env.update(WIRE_CMD_ENV, PYTHONPATH=str(root))
    replica = _Replica({**env, "SERVING_TRANSPORT": WIRE_CMD_TRANSPORT},
                       root)
    decoder = _Replica({**env, "GEN_ROLE": "decode"}, root)
    proc, log = replica.proc, replica.log
    try:
        port = replica.port()
        startup = time.perf_counter() - replica.t0
        status, _, body = _http(port, "GET", "/healthz")
        if (status, json.loads(body)) != (200, {"status": "ok"}):
            raise AssertionError(f"/healthz: {status} {body}")
        # the replica's first request pays the first launches and the
        # library handles: timed on its own, before the 4 streams
        first = _wire_stream(port, [1, 2, 3], 2, "default")
        _check_wire([first], 32768)
        snap0 = json.loads(_http(port, "GET", "/v1/models/default")[2])[
            "generator"]
        if snap0["device"] != WIRE_CMD_DEVICE \
                or snap0["prefill_chunk"] != 256:
            raise AssertionError(f"/v1/models/default: device "
                                 f"{snap0['device']}, prefill_chunk "
                                 f"{snap0['prefill_chunk']}")
        reqs = [r for i, r in enumerate(requests(5, 32768)) if i != 1]
        results, wall = _wire_clients(
            port, reqs, "default",
            [{"X-Tenant": t} for t in WIRE_CMD_TENANTS])
        _check_wire(results, 32768)
        _check_qos_classes(results, WIRE_CMD_TENANTS)
        snap1 = json.loads(_http(port, "GET", "/v1/models/default")[2])[
            "generator"]
        prefills = snap1["stats"]["prefills"] - snap0["stats"]["prefills"]
        chunks = snap1["prefill_chunks"] - snap0["prefill_chunks"]
        metrics = _http(port, "GET", "/metrics")[2].decode()
        m = re.search(r'^serving_generate_tokens_total\{model="default"\} '
                      r'(\S+)$', metrics, re.M)
        qos_tokens = _qos_tokens(metrics)
        dport = decoder.port()
        # a prompt the 4 streams served: the export is a prefix hit (K2)
        hop_prompt = requests(5, 32768)[2][0]               # 200 tokens
        hop = disagg_hop(port, dport, hop_prompt, 8, "default")
        hop_tokens = check_hop(hop, 8, 32768)
        dsnap = json.loads(_http(dport, "GET", "/v1/models/default")[2])[
            "generator"]
        drain = _http(port, "POST", "/admin/drain", {})
        refused = _http(port, "POST", "/v1/models/default:generate",
                        {"tokens": [1, 2], "max_tokens": 2})
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        decoder.proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=30)
        dcode = decoder.proc.wait(timeout=30)
        row = {"phase": "wire_cmd", "dtype": WIRE_CMD_ENV["GEN_DTYPE"],
               "transport": WIRE_CMD_TRANSPORT,
               "decode_transport": "threaded",
               "heads": int(WIRE_CMD_ENV["GEN_HEADS"]),
               "kv_heads": int(WIRE_CMD_ENV["GEN_HEADS"]),
               "prefill_chunk": int(WIRE_CMD_ENV["GEN_PREFILL_CHUNK"]),
               "requests": len(reqs),
               "prompt_lens": [len(p) for p, _ in reqs],
               "startup_s": startup,
               "first_request_ttft_ms": 1e3 * first["frames"][-1]["ttft_s"],
               **_wire_numbers(results, wall),
               "prefills": prefills, "prefill_chunks": chunks,
               "tokens_total_metric": float(m.group(1)) if m else None,
               "tenants": list(WIRE_CMD_TENANTS),
               "qos_classes": [r["head"].get("x-qos-class")
                               for r in results],
               "qos_tokens_metric": {f"{t}/{c}": v for (t, c), v
                                     in sorted(qos_tokens.items())},
               "drain": drain[0], "after_drain": refused[0],
               "retry_after": refused[1].get("retry-after"),
               "hop": {"prompt": len(hop_prompt), "tokens": len(hop_tokens),
                       "export_prefix_tokens_skipped": int(hop[
                           "prefill_head"]["x-prefix-tokens-skipped"]),
                       "bundle_bytes": hop["bundle_bytes"],
                       "kv_bytes_migrated": int(hop["attach_head"][
                           "x-kv-bytes-migrated"]),
                       "decode_role": dsnap["role"],
                       "decode_migration": dsnap["migration"],
                       "decode_prefills": dsnap["stats"]["prefills"],
                       "decode_device": dsnap["device"],
                       "ttft_ms": 1e3 * hop["frames"][-1]["ttft_s"]},
               "sigterm_exit": code, "decode_sigterm_exit": dcode,
               "sigterm_s": time.perf_counter() - t_term}
        emit(row)
    finally:
        replica.stop()
        decoder.stop()
    if chunks <= prefills:
        raise AssertionError(f"{chunks} prefill chunks for {prefills} "
                             f"prefills: nothing was chunked (K2)")
    if not row["tokens_total_metric"]:
        raise AssertionError("serving_generate_tokens_total is not > 0")
    for tenant in sorted(set(WIRE_CMD_TENANTS)):
        key = (tenant, QOS_TENANTS[tenant]["class"])
        if not qos_tokens.get(key):
            raise AssertionError(f"serving_qos_tokens_total{key} is not "
                                 f"> 0: {qos_tokens}")
    if drain[0] != 200 or refused[0] != 503 or row["retry_after"] != "1":
        raise AssertionError(f"drain {drain[0]}, then :generate "
                             f"{refused[0]} (Retry-After "
                             f"{row['retry_after']}), want 200 then 503")
    if code != 0 or dcode != 0:
        raise AssertionError(f"SIGTERM exit codes {code}, {dcode}: "
                             f"{log[-20:]} {decoder.log[-20:]}")
    check_transport_log(log, WIRE_CMD_TRANSPORT)
    check_transport_log(decoder.log, "threaded")
    h = row["hop"]
    if h["decode_role"] != "decode" or h["decode_prefills"] \
            or h["decode_migration"]["imports"] != 1 \
            or h["decode_device"] != WIRE_CMD_DEVICE:
        raise AssertionError(f"the GEN_ROLE=decode replica: {h}")
    return row


#: the QoS schedule at the flagship's size (the shape of
#: ``bench.py:1445-1489``): batch streams of distinct 512-token prompts
#: (32 full blocks) and interactive streams of distinct 64-token prompts,
#: the latter submitted 100 ms apart once every slot has emitted a token
QOS_SLOTS = 4
QOS_PROMPTS = {"batch": 512, "interactive": 64}
QOS_GAP_S = 0.1


def qos_requests(vocab, n_batch, batch_tokens, n_inter, inter_tokens=16,
                 seed=5):
    """→ (batch, interactive) lists of ``(prompt, max_tokens)``, distinct
    prompts drawn from ``seed``: they share no block, so only a resume
    reads cached pages."""
    rng = np.random.default_rng(seed)
    batch = [(rng.integers(0, vocab, QOS_PROMPTS["batch"]).tolist(),
              batch_tokens) for _ in range(n_batch)]
    inter = [(rng.integers(0, vocab, QOS_PROMPTS["interactive"]).tolist(),
              inter_tokens) for _ in range(n_inter)]
    return batch, inter


def _pctl(vals, q):
    """The engine's percentile rule (``token_latency_stats``): the
    sample at index ``int(q · n)`` of the sorted values."""
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def _qos_run(eng, batch, inter, kernel_fns):
    """Warm ``eng`` up, set every launch count to 0, submit the
    ``batch`` streams (tenant ``crawler``) together; once every slot has
    emitted a token, the ``inter`` streams (tenant ``acme``) one every
    ``QOS_GAP_S``; wait for all and read the counts → dict of the
    streams (handle, tenant, token indices, lifecycle events), the
    launches, the stats before and after, the wall and the timeline."""
    eng.generate([1, 2, 3], max_tokens=2)        # warm-up
    for fn in kernel_fns.values():
        fn.launches = 0
    s0 = dict(eng.stats)
    streams = []

    def submit(prompt, m, tenant):
        st = {"tenant": tenant, "indices": [], "events": []}
        st["handle"] = eng.submit(
            prompt, max_tokens=m, tenant=tenant,
            on_token=lambda t, i: st["indices"].append(i),
            on_event=lambda ev, at: st["events"].append((ev, at)))
        streams.append(st)
        return st["handle"]

    t0 = time.perf_counter()
    first = [submit(p, m, "crawler") for p, m in batch]
    deadline = time.monotonic() + 300
    while sum(1 for h in first if h.out_tokens) < min(eng.max_slots,
                                                       len(first)):
        if time.monotonic() > deadline:
            raise AssertionError("the batch streams never filled the slots")
        time.sleep(0.001)
    for k, (p, m) in enumerate(inter):
        if k:
            time.sleep(QOS_GAP_S)
        submit(p, m, "acme")
    for st in streams:
        st["handle"].result(timeout=600)
    wall = time.perf_counter() - t0
    return {"streams": streams, "wall": wall, "s0": s0,
            "s1": dict(eng.stats),
            "launches": {n: fn.launches for n, fn in kernel_fns.items()},
            "timeline": eng.timeline_view(),
            "latency": eng.token_latency_stats()}


def _admission_order(timeline, seqs):
    """The requests among ``seqs`` in the order of their ``admitted``
    events (a resume's included)."""
    seqs = set(seqs)
    return [e["request"] for e in timeline
            if e["event"] == "admitted" and e["request"] in seqs]


def _check_streams(streams, vocab):
    """Every stream spent its whole budget, and its token indices run
    0, 1, ... without a gap across its suspensions."""
    for i, st in enumerate(streams):
        h = st["handle"]
        if h.reason != "length" or len(h.out_tokens) != h.max_tokens \
                or st["indices"] != list(range(h.max_tokens)) \
                or not all(0 <= t < vocab for t in h.out_tokens):
            raise AssertionError(
                f"stream {i} ({st['tenant']}): ended {h.reason!r} with "
                f"{len(h.out_tokens)} of {h.max_tokens} tokens, indices "
                f"{st['indices'][:8]}...")


def _check_resumes(resumes, floor, most):
    """Each resume (its ``resumed`` event's attributes) skipped at least
    ``floor`` prefix tokens and re-prefilled at most ``most``."""
    if not resumes:
        raise AssertionError("no stream resumed")
    bad = [r for r in resumes if r["prefix_tokens_skipped"] < floor
           or r["prefilled"] > most]
    if bad:
        raise AssertionError(f"resumes outside skipped >= {floor}, "
                             f"prefilled <= {most}: {bad}")


def _qos_numbers(run, names):
    """The numbers of one ``_qos_run``: interactive TTFT p50/p95 from the
    handles and the engine's own ``token_latency_stats``, tokens/s over
    the wall, preemptions, resumes, resume prefill tokens, the smallest
    skip and largest re-prefill of a resume, the batch streams' ITG max,
    and the launches of ``names``."""
    st = run["streams"]
    inter = [s["handle"] for s in st if s["tenant"] == "acme"]
    batch = [s["handle"] for s in st if s["tenant"] == "crawler"]
    resumes = [at for s in st for ev, at in s["events"] if ev == "resumed"]
    ttft = [h.ttft_s for h in inter]
    d = {k: run["s1"][k] - run["s0"][k] for k in (
        "preemptions", "resumes", "resume_prefill_tokens", "decode_steps",
        "decode_seconds_total")}
    n_tokens = sum(len(s["handle"].out_tokens) for s in st)
    return {
        "interactive_ttft_p50_ms": 1e3 * statistics.median(ttft),
        "interactive_ttft_p95_ms": 1e3 * _pctl(ttft, 0.95),
        "engine_latency": run["latency"],
        "tokens": n_tokens, "wall_s": run["wall"],
        "tokens_per_s": n_tokens / run["wall"],
        "decode_step_ms": 1e3 * d["decode_seconds_total"]
                          / d["decode_steps"],
        "preemptions": d["preemptions"], "resumes": d["resumes"],
        "resume_prefill_tokens": d["resume_prefill_tokens"],
        "resume_skip_min": min((r["prefix_tokens_skipped"]
                                for r in resumes), default=None),
        "resume_prefilled_max": max((r["prefilled"] for r in resumes),
                                    default=None),
        "batch_itg_max_ms": 1e3 * max(g for h in batch for g in h.itg_gaps),
        "launches": {n: run["launches"][n] for n in names}}


def _qos_engine(params, cfg, name, max_slots=QOS_SLOTS, **kw):
    """The QoS phases' engine: block 16, the paged backend, the prefix
    cache on unless ``kw`` says otherwise, the tenants' ledger."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    from kubeflow_tpu_torch.qos import buckets as qos_lib
    return gen_lib.GenerationEngine(
        params, cfg, max_slots=max_slots, block_size=16, max_context=1024,
        attn_backend="paged", qos=qos_lib.TokenLedger(QOS_TENANTS),
        name=name, **kw)


def phase_qos(params, kernel_fns):
    """QoS classes and preemptible decoding on the bf16 flagship (4
    slots, block 16, prefix cache on, paged backend): 8 batch streams
    (``crawler``) of distinct 512-token prompts, 128 tokens each, and
    once all 4 slots have emitted, 8 interactive streams (``acme``) of
    64 tokens, 16 each, 100 ms apart — on a FIFO engine
    (``preemption=False``), then on a preempting one. FIFO suspends
    nothing and admits in submit order, K2 never launches; with
    preemption every resume skips the 32 retained blocks and re-prefills
    at most 2, K2 launches 12 times a resume (only resumes read cached
    pages) and interactive TTFT p95 is at least 2× better than FIFO's.
    The preempted streams' tokens against FIFO's are printed; the fp32
    reduced schedule (``_qos_fp32``) holds them equal. The counts of the
    preemption run are the path's."""
    import torch
    cfg = flagship_config()
    batch, inter = qos_requests(cfg.vocab_size, 8, 128, 8)
    names = ("paged_decode", "paged_chunk", "flash_fwd")
    runs = {}
    for mode, preemption in (("fifo", False), ("preemption", True)):
        eng = _qos_engine(params, cfg, f"qos-{mode}", preemption=preemption)
        try:
            runs[mode] = _qos_run(eng, batch, inter, kernel_fns)
        finally:
            eng.close()
        _check_streams(runs[mode]["streams"], cfg.vocab_size)
    torch.cuda.empty_cache()
    fifo, pre = runs["fifo"], runs["preemption"]
    nums = {m: _qos_numbers(r, names) for m, r in runs.items()}
    seqs = [s["handle"].seq for s in fifo["streams"]]
    fifo_order = _admission_order(fifo["timeline"], seqs)
    preempted = [i for i, s in enumerate(pre["streams"])
                 if s["handle"].preemptions]
    same = sum(pre["streams"][i]["handle"].out_tokens
               == fifo["streams"][i]["handle"].out_tokens for i in preempted)
    fp32 = _qos_fp32(params)
    row = {"phase": "qos", "dtype": "bfloat16", "slots": QOS_SLOTS,
           "batch_streams": len(batch), "interactive_streams": len(inter),
           "prompts": QOS_PROMPTS, "max_tokens": {"batch": 128,
                                                  "interactive": 16},
           **nums,
           "ttft_p95_gain": nums["fifo"]["interactive_ttft_p95_ms"]
                            / nums["preemption"]["interactive_ttft_p95_ms"],
           "fifo_admission_in_submit_order": fifo_order == sorted(seqs),
           "bf16_preempted_streams": len(preempted),
           "bf16_preempted_equal_to_fifo": same,
           "bf16_first_mismatch": _first_mismatches(
               [pre["streams"][i]["handle"].out_tokens for i in preempted],
               [fifo["streams"][i]["handle"].out_tokens for i in preempted]),
           "fp32": fp32, "launches": pre["launches"]}
    emit(row)
    f, p = nums["fifo"], nums["preemption"]
    if f["preemptions"] or fifo_order != sorted(seqs):
        raise AssertionError(f"FIFO preempted {f['preemptions']} times or "
                             f"admitted {fifo_order}, not {sorted(seqs)}")
    if p["preemptions"] < 1 or p["resumes"] != p["preemptions"]:
        raise AssertionError(f"{p['preemptions']} preemptions, "
                             f"{p['resumes']} resumes")
    _check_resumes([at for s in pre["streams"] for ev, at in s["events"]
                    if ev == "resumed"], QOS_PROMPTS["batch"], 32)
    if p["launches"]["paged_chunk"] != cfg.n_layers * p["resumes"] \
            or f["launches"]["paged_chunk"]:
        raise AssertionError(f"K2 launched {p['launches']['paged_chunk']} "
                             f"times for {p['resumes']} resumes (want "
                             f"{cfg.n_layers} each) and "
                             f"{f['launches']['paged_chunk']} on FIFO "
                             f"(want 0)")
    _require(f["launches"], ("paged_decode", "flash_fwd"), "qos FIFO")
    _require(p["launches"], ("paged_decode", "flash_fwd"), "qos")
    if row["ttft_p95_gain"] < 2:
        raise AssertionError(
            f"interactive TTFT p95 {p['interactive_ttft_p95_ms']} ms with "
            f"preemption against FIFO's {f['interactive_ttft_p95_ms']}: "
            f"{row['ttft_p95_gain']:.2f}x, want >= 2x")
    return row


def _qos_fp32(params):
    """The fp32 flagship at full width on a reduced schedule (2 slots, 3
    batch streams of 512 tokens x 48, 2 interactive): the uninterrupted
    FIFO engine (prefix cache off, ``debug_logits``) against the
    preempting one. Every preempted stream's tokens equal the FIFO
    engine's but where its top-2 logit gap is below 1e-3
    (``_agreement``) → the report."""
    import torch
    cfg = flagship_config("float32")
    batch, inter = qos_requests(cfg.vocab_size, 3, 48, 2, seed=6)
    runs = {}
    for mode, kw in (("fifo", dict(preemption=False, prefix_cache=False,
                                   debug_logits=True)),
                     ("preemption", dict(preemption=True))):
        eng = _qos_engine(params, cfg, f"qos-fp32-{mode}", max_slots=2, **kw)
        try:
            runs[mode] = _qos_run(eng, batch, inter, {})
        finally:
            eng.close()
        _check_streams(runs[mode]["streams"], cfg.vocab_size)
    torch.cuda.empty_cache()
    fifo, pre = runs["fifo"]["streams"], runs["preemption"]["streams"]
    preempted = [i for i, s in enumerate(pre) if s["handle"].preemptions]
    if not preempted:
        raise AssertionError("the fp32 schedule preempted no stream")
    report = _agreement([pre[i]["handle"].out_tokens for i in preempted],
                        [fifo[i]["handle"].out_tokens for i in preempted],
                        [fifo[i]["handle"].logits for i in preempted])
    return {"preempted_streams": len(preempted),
            "preemptions": sum(pre[i]["handle"].preemptions
                               for i in preempted),
            "equal": sum(e["first_mismatch"] is None for e in report),
            "per_stream": report}


def phase_qos_i8(params, kernel_fns, bf16_row):
    """The preemption run of ``phase_qos`` alone on an int8 pool: every
    resume reads its int8 prefix pages through K2-i8 (exactly 12
    launches a resume), decode reads through K1-i8, and K1 and K2 never
    launch; interactive TTFT p95 beside the bf16 run's."""
    import torch
    cfg = flagship_config()
    batch, inter = qos_requests(cfg.vocab_size, 8, 128, 8)
    eng = _qos_engine(params, cfg, "qos-int8", kv_dtype="int8")
    try:
        run = _qos_run(eng, batch, inter, kernel_fns)
    finally:
        eng.close()
    torch.cuda.empty_cache()
    _check_streams(run["streams"], cfg.vocab_size)
    names = ("paged_decode_i8", "paged_chunk_i8", "flash_fwd",
             "paged_decode", "paged_chunk")
    p = _qos_numbers(run, names)
    row = {"phase": "qos_i8", "dtype": "bfloat16", "kv_dtype": "int8",
           "slots": QOS_SLOTS, **p,
           "bf16_interactive_ttft_p95_ms":
               bf16_row["preemption"]["interactive_ttft_p95_ms"],
           "launches": run["launches"]}
    emit(row)
    if p["preemptions"] < 1 or p["resumes"] != p["preemptions"]:
        raise AssertionError(f"int8: {p['preemptions']} preemptions, "
                             f"{p['resumes']} resumes")
    _check_resumes([at for s in run["streams"] for ev, at in s["events"]
                    if ev == "resumed"], QOS_PROMPTS["batch"], 32)
    if p["launches"]["paged_chunk_i8"] != cfg.n_layers * p["resumes"]:
        raise AssertionError(f"K2-i8 launched "
                             f"{p['launches']['paged_chunk_i8']} times for "
                             f"{p['resumes']} resumes (want {cfg.n_layers} "
                             f"each)")
    _require(run["launches"], ("paged_decode_i8", "flash_fwd"), "qos_i8")
    _refuse(run["launches"], ("paged_decode", "paged_chunk"), "qos_i8")
    return row


#: the disaggregation schedule at the flagship's size (the shape of
#: ``bench.py:1712-1850``): short streams of distinct 64-token prompts,
#: 128 tokens each; once every one has emitted ``DISAGG_ARRIVAL`` tokens
#: an 896-token intruder arrives with a budget of 8 — colocated, or as a
#: page import whose bundle a prefill-role engine built before the wave
#: (one card cannot play two replicas)
DISAGG_SHORTS = (4, 64, 128)          # streams, prompt tokens, budget
DISAGG_INTRUDER = (896, 8)            # prompt tokens, budget
DISAGG_ARRIVAL = 16
DISAGG_HIT_PREFIX = 512               # tokens a follow-up shares


def disagg_requests(vocab, seed=7):
    """→ (short streams as ``(prompt, max_tokens)``, the intruder's
    prompt), distinct prompts drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n, length, budget = DISAGG_SHORTS
    shorts = [(rng.integers(0, vocab, length).tolist(), budget)
              for _ in range(n)]
    return shorts, rng.integers(0, vocab, DISAGG_INTRUDER[0]).tolist()


def bundle_bytes(n_blocks, block_size, n_layers, kv_heads, head_dim,
                 itemsize, int8=False):
    """(page bytes, scale bytes) a bundle of ``n_blocks`` ships: k and v
    pages in the pool's dtype, plus one fp32 scale per (position, head)
    of each on an int8 pool."""
    rows = n_blocks * block_size * n_layers * kv_heads * 2
    return rows * head_dim * itemsize, rows * 4 if int8 else 0


def itg_stats(gaps):
    """Inter-token gaps (s) → p50 / p99 / max in ms by the engine's
    percentile rule (``_pctl``), and their count."""
    return {"gaps": len(gaps), "p50_ms": 1e3 * _pctl(gaps, 0.50),
            "p99_ms": 1e3 * _pctl(gaps, 0.99), "max_ms": 1e3 * max(gaps)}


def launch_delta(before, after):
    """Launches between two reads of the counts, per kernel."""
    return {k: after[k] - before[k] for k in after}


def launch_sum(*runs):
    """Launch counts of several attributed runs, added per kernel."""
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def _launches(kernel_fns):
    return {name: fn.launches for name, fn in kernel_fns.items()}


def _zero(kernel_fns):
    for fn in kernel_fns.values():
        fn.launches = 0


def _encode_body(bundle):
    """A bundle as the prefill replica puts it on the wire → (its framing
    headers, the body as the decode replica reads it: a bytearray)."""
    from kubeflow_tpu_torch.compute import serving
    parts, framing, _ = serving.encode_kv_bundle(bundle)
    return dict(framing), bytearray(b"".join(bytes(p) for p in parts))


def _wire_bundle(bundle):
    """A bundle through the port's x-tensor codec → the decoded bundle."""
    from kubeflow_tpu_torch.compute import serving
    return serving.decode_kv_bundle(*_encode_body(bundle))


def _same_bits(a, b):
    """Two page tensors (any device) hold the same bytes."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.cpu().contiguous().view(torch.uint8),
        b.cpu().contiguous().view(torch.uint8))


def _landing(eng, prompt, n_blocks, out):
    """An ``on_token`` that, at the first token of the slot holding
    ``prompt`` (installed, before any decode step), copies its first
    ``n_blocks`` blocks out of every pool component into ``out``."""
    import torch

    def on_token(token, index):
        if index:
            return
        slot = next(s for s in eng._slots
                    if s is not None and s.handle.prompt == prompt)
        idx = torch.tensor(slot.blocks[:n_blocks], device=eng.device)
        out["pages"] = [comp.index_select(1, idx) for comp in eng._cache]
    return on_token


def _disagg_wave(eng, shorts, kernel_fns, arrive=None):
    """Zero the launch counts, submit the ``shorts`` together; once each
    has emitted ``DISAGG_ARRIVAL`` tokens, ``arrive()`` (the intruder's
    submit or import → its handle); wait for all and read the counts →
    dict of the handles, the counts and the stats at arrival and at the
    end, and the client's seconds from arrival to the intruder's first
    token."""
    _zero(kernel_fns)
    s0 = dict(eng.stats)
    hs = [eng.submit(p, max_tokens=m) for p, m in shorts]
    deadline = time.monotonic() + 300
    while not all(len(h.out_tokens) >= DISAGG_ARRIVAL for h in hs):
        if time.monotonic() > deadline:
            raise AssertionError("the short streams never decoded")
        time.sleep(0.001)
    at = _launches(kernel_fns)
    s_at = dict(eng.stats)
    gaps_at = [len(h.itg_gaps) for h in hs]
    hi = first_s = None
    if arrive is not None:
        t0 = time.perf_counter()
        hi = arrive()
        while not hi.out_tokens and not hi.done():
            if time.monotonic() > deadline:
                raise AssertionError("the intruder never emitted")
            time.sleep(0.0005)
        first_s = time.perf_counter() - t0
    outs = [h.result(timeout=600) for h in hs]
    intruder = hi.result(timeout=600) if hi is not None else None
    return {"handles": hs, "outs": outs, "intruder": hi,
            "intruder_out": intruder, "first_token_s": first_s,
            "at_arrival": at, "end": _launches(kernel_fns),
            "gaps_at_arrival": gaps_at, "stats": (s0, s_at, dict(eng.stats)),
            "timeline": eng.timeline_view()}


def _check_disagg_streams(run, vocab):
    shorts = [(h.prompt, h.max_tokens) for h in run["handles"]]
    _check_served(shorts, run["outs"], vocab)
    if run["intruder"] is not None:
        _check_served([(run["intruder"].prompt, DISAGG_INTRUDER[1])],
                      [run["intruder_out"]], vocab)


def _wave_numbers(run):
    """One wave's numbers: the short streams' ITG over the whole wave
    and from the intruder's arrival on (the window it can stall; the
    wave's first gaps carry the 4 streams' own admission), split into
    the two gaps each stream had around the arrival (``arrival_gap_max``:
    where a prefill or an import lands) and the rest, the
    intruder's TTFT on the engine's clock (colocated: its prefill;
    disagg: import_bundle → first token) and on the client's, an
    import's queue wait and admission (copy-in, trie seed) from its
    timeline events, and the prefills and launches after the arrival."""
    s0, s_at, s1 = run["stats"]
    row = {"itg": itg_stats([g for h in run["handles"] for g in h.itg_gaps]),
           "itg_after_arrival": itg_stats([
               g for h, n in zip(run["handles"], run["gaps_at_arrival"])
               for g in h.itg_gaps[n:]]),
           "arrival_gap_max_ms": 1e3 * max(
               g for h, n in zip(run["handles"], run["gaps_at_arrival"])
               for g in h.itg_gaps[n:n + 2]),
           "later_gap_max_ms": 1e3 * max(
               g for h, n in zip(run["handles"], run["gaps_at_arrival"])
               for g in h.itg_gaps[n + 2:]),
           "decode_step_ms": 1e3 * (s1["decode_seconds_total"]
                                    - s0["decode_seconds_total"])
                             / (s1["decode_steps"] - s0["decode_steps"]),
           "prefills_after_arrival": s1["prefills"] - s_at["prefills"],
           "launches_after_arrival": launch_delta(run["at_arrival"],
                                                  run["end"])}
    if run["intruder"] is not None:
        row["intruder_ttft_ms"] = 1e3 * run["intruder"].ttft_s
        row["intruder_first_token_client_ms"] = 1e3 * run["first_token_s"]
        events = {e["event"]: e for e in run["timeline"]
                  if e["request"] == run["intruder"].seq}
        if "imported" in events:
            row["import_queue_wait_ms"] = 1e3 * events["admitted"]["wait_s"]
            row["import_admission_ms"] = 1e3 * (events["imported"]["ts"]
                                                - events["admitted"]["ts"])
    return row


def _disagg_engines(params, cfg, kv_dtype, tag):
    """The prefill-role exporter (1 slot), the decode-role importer and a
    colocated engine of the same geometry (5 slots each); block 16, the
    prefix cache off, monolithic prefill."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    kw = dict(block_size=16, max_context=1024, prefix_cache=False,
              kv_dtype=kv_dtype)
    slots = DISAGG_SHORTS[0] + 1
    return (gen_lib.GenerationEngine(params, cfg, max_slots=1, role="prefill",
                                     name=f"{tag}-prefill", **kw),
            gen_lib.GenerationEngine(params, cfg, max_slots=slots,
                                     role="decode", name=f"{tag}-decode",
                                     **kw),
            gen_lib.GenerationEngine(params, cfg, max_slots=slots,
                                     role="both", name=f"{tag}-colocated",
                                     **kw))


def _disagg_run(params, cfg, kernel_fns, kv_dtype=None):
    """The three topologies on one schedule (``disagg_requests``):
    baseline (no intruder) and colocated on the colocated engine, disagg
    on the decode engine with the intruder's bundle, exported before the
    wave and carried through the codec, imported mid-wave. Counts are
    zeroed before the export and again before each wave → dict."""
    import torch
    from kubeflow_tpu_torch.compute import serving
    tag = "disagg" if kv_dtype is None else f"disagg-{kv_dtype}"
    shorts, intruder = disagg_requests(cfg.vocab_size)
    budget = DISAGG_INTRUDER[1]
    pre, dec, colo = _disagg_engines(params, cfg, kv_dtype, tag)
    warm = disagg_requests(cfg.vocab_size, seed=9)
    try:
        # warm-up, no migration: a wave of 4 on the decoding engines, an
        # 896-token prefill on the two that prefill the intruder
        for eng in (dec, colo):
            for h in [eng.submit(p, max_tokens=4) for p, _ in warm[0]]:
                h.result(timeout=600)
        for eng in (pre, colo):
            eng.generate(warm[1], max_tokens=2)
        _zero(kernel_fns)
        t0 = time.perf_counter()
        bundle = pre.prefill_export(intruder, max_tokens=budget)
        export_ms = 1e3 * (time.perf_counter() - t0)
        export_launches = _launches(kernel_fns)
        # the export's device→host copy (``_build_kv_bundle``'s) alone,
        # timed again on as many blocks of the same pool
        n = bundle["meta"]["n_blocks"]
        idx = torch.arange(n, device=pre.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for comp in pre._cache:
            comp.index_select(1, idx).cpu()
        copy_ms = 1e3 * (time.perf_counter() - t0)
        framing, body = _encode_body(bundle)
        t0 = time.perf_counter()
        wired = serving.decode_kv_bundle(framing, body)
        decode_ms = 1e3 * (time.perf_counter() - t0)
        runs = {"baseline": _disagg_wave(colo, shorts, kernel_fns),
                "colocated": _disagg_wave(
                    colo, shorts, kernel_fns,
                    lambda: colo.submit(intruder, max_tokens=budget))}
        landed = {}
        # the decode replica reads the body when it arrives: the
        # migration clock (``_t_recv``) starts there
        runs["disagg"] = _disagg_wave(
            dec, shorts, kernel_fns, lambda: dec.import_bundle(
                serving.decode_kv_bundle(framing, body),
                on_token=_landing(dec, intruder, n, landed)))
        imported = next(e for e in dec.timeline_view()
                        if e["event"] == "imported")
        snaps = {"prefill": pre.snapshot()["migration"],
                 "decode": dec.snapshot()["migration"]}
        pre_bytes = pre.stats["kv_bytes_migrated"]
    finally:
        for eng in (pre, dec, colo):
            eng.close()
    torch.cuda.empty_cache()
    for run in runs.values():
        _check_disagg_streams(run, cfg.vocab_size)
    return {"bundle": bundle, "wired": wired, "framing": framing,
            "body_len": len(body), "export_ms": export_ms,
            "export_copy_ms": copy_ms, "wire_decode_ms": decode_ms,
            "export_launches": export_launches, "runs": runs,
            "landed": landed.get("pages"), "imported": imported,
            "snaps": snaps, "pre_bytes": pre_bytes, "intruder": intruder}


def _check_disagg(run, cfg, kv_dtype, path):
    """The asserts every disagg path shares."""
    meta = run["bundle"]["meta"]
    itemsize = 1 if kv_dtype == "int8" else 2
    want = bundle_bytes(-(-DISAGG_INTRUDER[0] // 16), 16, cfg.n_layers,
                        cfg.kv_heads, cfg.head_dim, itemsize,
                        int8=kv_dtype == "int8")
    got = (meta["page_bytes"], meta["scale_bytes"])
    meta_len = int(run["framing"]["X-KV-Meta-Bytes"])
    if got != want or run["body_len"] != meta_len + sum(got) \
            or run["pre_bytes"] != sum(got):
        raise AssertionError(f"{path}: bundle bytes {got}, want {want}; "
                             f"body {run['body_len']} = meta {meta_len} + "
                             f"{sum(got)}?; exporter booked "
                             f"{run['pre_bytes']}")
    if run["export_launches"]["flash_fwd"] != cfg.n_layers \
            or sum(run["export_launches"].values()) != cfg.n_layers:
        raise AssertionError(f"{path}: the export launched "
                             f"{run['export_launches']}, want K3 "
                             f"{cfg.n_layers} times and nothing else")
    dis = run["runs"]["disagg"]
    nums = _wave_numbers(dis)
    k3 = nums["launches_after_arrival"]["flash_fwd"]
    if nums["prefills_after_arrival"] or k3:
        raise AssertionError(f"{path}: the decode engine ran "
                             f"{nums['prefills_after_arrival']} prefills "
                             f"and {k3} K3 launches for the imported "
                             f"intruder")
    if dis["intruder_out"][0][0] != meta["first_token"]:
        raise AssertionError(f"{path}: the import streamed "
                             f"{dis['intruder_out'][0][0]} first, the "
                             f"bundle says {meta['first_token']}")
    if run["landed"] is None or not all(
            _same_bits(a, b)
            for a, b in zip(run["landed"], run["wired"]["pages"])):
        raise AssertionError(f"{path}: the imported blocks differ from the "
                             f"bundle's pages")
    if not all(_same_bits(a, b) for a, b in zip(run["wired"]["pages"],
                                                run["bundle"]["pages"])):
        raise AssertionError(f"{path}: the codec changed the pages")
    if (run["snaps"]["prefill"]["exports"], run["snaps"]["decode"]["imports"]
            ) != (1, 1):
        raise AssertionError(f"{path}: migration views {run['snaps']}, "
                             f"want 1 export and 1 import")


def _disagg_row(phase, run, cfg, kv_dtype):
    """The printed row of a disagg path; its ``launches`` are the export's
    plus the disagg wave's (counted apart, each engine its own run)."""
    meta = run["bundle"]["meta"]
    waves = {t: _wave_numbers(r) for t, r in run["runs"].items()}
    col, dis = run["runs"]["colocated"], run["runs"]["disagg"]
    return {"phase": phase, "dtype": "bfloat16",
            "kv_dtype": kv_dtype or "bfloat16",
            "shorts": DISAGG_SHORTS[0], "short_prompt": DISAGG_SHORTS[1],
            "short_budget": DISAGG_SHORTS[2],
            "intruder": list(DISAGG_INTRUDER), "arrival": DISAGG_ARRIVAL,
            "n_blocks": meta["n_blocks"], "page_bytes": meta["page_bytes"],
            "scale_bytes": meta["scale_bytes"],
            "export_ms": run["export_ms"],
            "export_copy_ms": run["export_copy_ms"],
            "wire_decode_ms": run["wire_decode_ms"],
            "kv_migration_seconds": run["imported"]["seconds"],
            "topologies": waves,
            "itg_max_after_arrival_vs_baseline": {
                t: waves[t]["itg_after_arrival"]["max_ms"]
                / waves["baseline"]["itg_after_arrival"]["max_ms"]
                for t in ("colocated", "disagg")},
            "bf16_agreement": {
                "intruder_equal": dis["intruder_out"][0]
                == col["intruder_out"][0],
                "intruder_first_mismatch": _first_mismatches(
                    [dis["intruder_out"][0]], [col["intruder_out"][0]])[0],
                "shorts_equal": {t: [o for o, _ in r["outs"]]
                                 == [o for o, _ in
                                     run["runs"]["baseline"]["outs"]]
                                 for t, r in run["runs"].items()}},
            "migration": run["snaps"],
            "export_launches": run["export_launches"],
            "wave_launches": dis["end"],
            "colocated_wave_launches": col["end"]}


def _disagg_hit(params, cfg, bundle, kernel_fns):
    """A decode-role engine with the prefix cache imports the intruder's
    bundle; a follow-up sharing its first ``DISAGG_HIT_PREFIX`` tokens is
    a prefix hit over the imported pages (K2 once a layer, no K3) →
    (dict, the follow-up's launches)."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    eng = gen_lib.GenerationEngine(params, cfg, max_slots=2, block_size=16,
                                   max_context=1024, role="decode",
                                   name="disagg-hit")
    prompt = bundle["meta"]["prompt"]
    follow = prompt[:DISAGG_HIT_PREFIX] + disagg_requests(
        cfg.vocab_size, seed=8)[0][0][0]
    try:
        eng.import_bundle(bundle, max_tokens=4).result(timeout=600)
        _zero(kernel_fns)
        h = eng.submit(follow, max_tokens=4)
        out = h.result(timeout=600)
        launches = _launches(kernel_fns)
    finally:
        eng.close()
    return {"follow_up_prompt": len(follow),
            "prefix_tokens_skipped": h.prefix_tokens_skipped,
            "reason": out[1], "launches": launches}, launches


def _disagg_fp32(params, intruder):
    """fp32 at full width, the intruder alone with 16 tokens: exported by
    a prefill-role engine, through the codec, imported by a decode-role
    one; its tokens against a colocated engine's (``debug_logits``) and
    the port's ``reference_greedy_decode``'s, equal but at top-2 logit
    gaps below 1e-3 (``_agreement``) → the report."""
    import torch
    from kubeflow_tpu_torch.compute import generate as gen_lib
    cfg = flagship_config("float32")
    kw = dict(max_slots=1, block_size=16, max_context=1024,
              prefix_cache=False)
    pre = gen_lib.GenerationEngine(params, cfg, role="prefill",
                                   name="disagg-fp32-prefill", **kw)
    dec = gen_lib.GenerationEngine(params, cfg, role="decode",
                                   name="disagg-fp32-decode", **kw)
    col = gen_lib.GenerationEngine(params, cfg, debug_logits=True,
                                   name="disagg-fp32-colocated", **kw)
    try:
        wired = _wire_bundle(pre.prefill_export(intruder, max_tokens=16))
        got = dec.import_bundle(wired).result(timeout=600)[0]
        h = col.submit(intruder, max_tokens=16)
        want = h.result(timeout=600)[0]
    finally:
        for eng in (pre, dec, col):
            eng.close()
    ref = gen_lib.reference_greedy_decode(
        params, flagship_config("float32", "dense"), intruder, 16)
    torch.cuda.empty_cache()
    return {"tokens": len(want),
            "disagg_vs_colocated": _agreement([got], [want], [h.logits])[0],
            "reference_vs_colocated": _agreement([ref], [want],
                                                 [h.logits])[0]}


def phase_disagg(params, kernel_fns):
    """Prefill/decode disaggregation on the bf16 flagship (block 16): a
    prefill-role engine (1 slot) exports the 896-token intruder's 56
    blocks (K3 exactly once a layer); the bundle goes through
    ``encode_kv_bundle`` → bytes → ``decode_kv_bundle``. Three topologies
    run one schedule of 4 short streams (64-token prompts, 128 tokens):
    baseline, colocated (the intruder submitted mid-wave to a role-both
    engine) and disagg (imported mid-wave by a decode-role engine, 5
    slots, the prefix cache off). The decode engine runs no prefill and
    no K3 for the intruder, decodes it on K1, lands its pages bit for bit
    and streams the bundle's first token first; each engine's migration
    view shows its one export or import; the bytes are 56 × 16 × 12 × 2 ×
    128 × 2 × 2. A follow-up sharing 512 tokens of the imported prompt on
    a prefix-caching decode engine is a hit: K2 12 times, no K3. In fp32
    at full width the disagg tokens equal the colocated engine's and the
    reference's but at top-2 gaps below 1e-3. ITG and the intruder's
    first token per topology are printed, not asserted."""
    cfg = flagship_config()
    run = _disagg_run(params, cfg, kernel_fns)
    hit, hit_launches = _disagg_hit(params, cfg, run["wired"], kernel_fns)
    fp32 = _disagg_fp32(params, run["intruder"])
    row = _disagg_row("disagg", run, cfg, None)
    row.update(hit=hit, fp32=fp32, launches=launch_sum(
        run["export_launches"], row["wave_launches"], hit_launches))
    emit(row)
    _check_disagg(run, cfg, None, "disagg")
    _require(row["wave_launches"], ("paged_decode",), "disagg wave")
    if hit["launches"]["paged_chunk"] != cfg.n_layers \
            or hit["launches"]["flash_fwd"] \
            or hit["prefix_tokens_skipped"] < DISAGG_HIT_PREFIX:
        raise AssertionError(f"the follow-up over imported pages: {hit}, "
                             f"want K2 {cfg.n_layers} times, no K3, "
                             f">= {DISAGG_HIT_PREFIX} tokens skipped")
    return row


def phase_disagg_i8(params, kernel_fns, bf16_row):
    """``phase_disagg``'s three topologies on an int8 pool: the import
    decodes on K1-i8 and never on K1, K2 never launches, the page bytes
    are half the bf16 bundle's with 56 × 16 × 2 × 4 × 2 × 12 scale bytes,
    and the bits land exactly."""
    cfg = flagship_config()
    run = _disagg_run(params, cfg, kernel_fns, kv_dtype="int8")
    row = _disagg_row("disagg_i8", run, cfg, "int8")
    row.update(bf16_page_bytes=bf16_row["page_bytes"],
               launches=launch_sum(run["export_launches"],
                                   row["wave_launches"]))
    emit(row)
    _check_disagg(run, cfg, "int8", "disagg_i8")
    if 2 * row["page_bytes"] != bf16_row["page_bytes"]:
        raise AssertionError(f"int8 bundle page bytes {row['page_bytes']} "
                             f"are not half of bf16's "
                             f"{bf16_row['page_bytes']}")
    _require(row["wave_launches"], ("paged_decode_i8",), "disagg_i8 wave")
    _refuse(row["launches"], ("paged_decode", "paged_chunk"), "disagg_i8")
    return row


def _http_raw(port, path, body, headers):
    """One POST of raw ``body`` → (status, head, body bytes)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, bytes(body), headers)
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                resp.read())
    finally:
        conn.close()


BUNDLE_HEADERS = ("X-KV-Meta-Bytes", "X-Tensor-Dtype", "X-Tensor-Shape")


def disagg_hop(prefill_port, decode_port, prompt, max_tokens, model):
    """The router's two hops: ``:prefill`` on one replica, its body and
    framing headers forwarded to ``:attach`` on the other → dict of both
    answers (the stream's frames parsed)."""
    status, head, body = _http(prefill_port, "POST",
                               f"/v1/models/{model}:prefill",
                               {"tokens": prompt, "max_tokens": max_tokens})
    out = {"prefill_status": status, "prefill_head": head,
           "bundle_bytes": len(body)}
    if status != 200:
        out["error"] = body.decode()
        return out
    framing = {h: head[h.lower()] for h in BUNDLE_HEADERS}
    out["meta"] = json.loads(body[:int(framing["X-KV-Meta-Bytes"])])
    status, ahead, data = _http_raw(
        decode_port, f"/v1/models/{model}:attach", body,
        {"Content-Type": "application/x-tensor", **framing})
    out.update(attach_status=status, attach_head=ahead)
    if status != 200:
        out["error"] = data.decode()
        return out
    out["frames"] = [json.loads(ln) for ln in data.splitlines()
                     if ln.strip()]
    return out


def check_hop(hop, max_tokens, vocab):
    """A two-hop answer: 200 x-tensor, then 200 NDJSON with contiguous
    token frames, the budget spent, and ``X-KV-Bytes-Migrated`` the
    bundle's page + scale bytes → the streamed tokens."""
    if hop["prefill_status"] != 200 or hop["prefill_head"].get(
            "content-type") != "application/x-tensor":
        raise AssertionError(f":prefill {hop['prefill_status']}: "
                             f"{hop.get('error') or hop['prefill_head']}")
    if hop.get("attach_status") != 200 or hop["attach_head"].get(
            "content-type") != "application/x-ndjson":
        raise AssertionError(f":attach {hop.get('attach_status')}: "
                             f"{hop.get('error')}")
    frames = hop["frames"]
    toks = [f["token"] for f in frames if "token" in f]
    if [f["index"] for f in frames if "token" in f] \
            != list(range(len(toks))) or not frames[-1].get("done") \
            or frames[-1]["tokens"] != toks or len(toks) != max_tokens \
            or not all(0 <= t < vocab for t in toks):
        raise AssertionError(f":attach stream: {frames}")
    meta = hop["meta"]
    want = str(meta["page_bytes"] + meta["scale_bytes"])
    if hop["attach_head"].get("x-kv-bytes-migrated") != want:
        raise AssertionError(f"X-KV-Bytes-Migrated "
                             f"{hop['attach_head'].get('x-kv-bytes-migrated')}"
                             f", want {want}")
    return toks


def _rejections(port, model, reason):
    """``serving_kv_import_rejections_total`` of ``reason`` on a
    server's ``/metrics``."""
    text = _http(port, "GET", "/metrics")[2].decode()
    m = re.search(rf'^serving_kv_import_rejections_total\{{model="{model}",'
                  rf'reason="{reason}"\}} (\S+)$', text, re.M)
    return float(m.group(1)) if m else 0.0


def phase_disagg_wire(params, kernel_fns):
    """The two hops over HTTP: two port ``ModelServer``s on 127.0.0.1, one
    over a prefill-role bf16 flagship engine and one over a decode-role
    one; this phase is the router: ``:prefill`` on the first, the body
    and its three framing headers to ``:attach`` on the second. Checked:
    both answers (``check_hop``), K3 on the export and K1 on the decode,
    the streamed tokens equal to the same hop in process on the same two
    engines right after, an int8 bundle on the bf16 pool answering 400
    naming ``dtype`` (its rejection counted on ``/metrics``), and
    ``:attach`` on the prefill-role server answering 400 naming
    ``role``. Then both servers listen on the async transport too and
    the same hop runs over it: the same tokens and
    ``X-KV-Bytes-Migrated`` as the threaded hop, K3 on the export and K1
    on the decode (its own row, ``transport`` async)."""
    import torch
    from kubeflow_tpu_torch.compute import generate as gen_lib
    from kubeflow_tpu_torch.compute import serving
    cfg = flagship_config()
    kw = dict(block_size=16, max_context=1024, prefix_cache=False)
    prompt = requests(5, cfg.vocab_size)[3][0]          # 300 tokens
    budget = 16
    pre = gen_lib.GenerationEngine(params, cfg, max_slots=1, role="prefill",
                                   name="disagg-wire-prefill", **kw)
    dec = gen_lib.GenerationEngine(params, cfg, max_slots=4, role="decode",
                                   name="disagg-wire-decode", **kw)
    i8 = gen_lib.GenerationEngine(params, cfg, max_slots=1, role="prefill",
                                  kv_dtype="int8", name="disagg-wire-i8",
                                  **kw)
    servers = {"prefill": serving.ModelServer(),
               "decode": serving.ModelServer()}
    servers["prefill"].register_generator(WIRE_MODEL, pre)
    servers["decode"].register_generator(WIRE_MODEL, dec)
    try:
        ports = {k: s.start(port=0, host="127.0.0.1")
                 for k, s in servers.items()}
        warm = disagg_hop(ports["prefill"], ports["decode"], [1, 2, 3], 2,
                          WIRE_MODEL)
        check_hop(warm, 2, cfg.vocab_size)
        _zero(kernel_fns)
        hop = disagg_hop(ports["prefill"], ports["decode"], prompt, budget,
                         WIRE_MODEL)
        launches = _launches(kernel_fns)
        streamed = check_hop(hop, budget, cfg.vocab_size)
        inproc = dec.import_bundle(_wire_bundle(pre.prefill_export(
            prompt, max_tokens=budget))).result(timeout=600)[0]
        parts, framing, _ = serving.encode_kv_bundle(
            i8.prefill_export(prompt[:40], max_tokens=4))
        before = _rejections(ports["decode"], dec.name, "dtype")
        wrong_dtype = _http_raw(
            ports["decode"], f"/v1/models/{WIRE_MODEL}:attach",
            b"".join(bytes(p) for p in parts),
            {"Content-Type": "application/x-tensor", **dict(framing)})
        after = _rejections(ports["decode"], dec.name, "dtype")
        _, head, body = _http(ports["prefill"], "POST",
                              f"/v1/models/{WIRE_MODEL}:prefill",
                              {"tokens": prompt[:20], "max_tokens": 2})
        wrong_role = _http_raw(
            ports["prefill"], f"/v1/models/{WIRE_MODEL}:attach", body,
            {"Content-Type": "application/x-tensor",
             **{h: head[h.lower()] for h in BUNDLE_HEADERS}})
        # the same servers and engines, a second listener each
        aports = {k: s.start(port=0, host="127.0.0.1", transport="async")
                  for k, s in servers.items()}
        check_hop(disagg_hop(aports["prefill"], aports["decode"],
                             [1, 2, 3], 2, WIRE_MODEL), 2, cfg.vocab_size)
        _zero(kernel_fns)
        ahop = disagg_hop(aports["prefill"], aports["decode"], prompt,
                          budget, WIRE_MODEL)
        alaunches = _launches(kernel_fns)
        astreamed = check_hop(ahop, budget, cfg.vocab_size)
    finally:
        for s in servers.values():
            s.stop()
        i8.close()
    torch.cuda.empty_cache()
    arow = {"phase": "disagg_wire", "dtype": "bfloat16",
            "transport": "async", "prompt": len(prompt),
            "max_tokens": budget, "bundle_bytes": ahop["bundle_bytes"],
            "kv_bytes_migrated": int(ahop["attach_head"][
                "x-kv-bytes-migrated"]),
            "ttft_ms": 1e3 * ahop["frames"][-1]["ttft_s"],
            "streamed_equal_threaded": astreamed == streamed,
            "first_mismatch": _first_mismatches([astreamed],
                                                [streamed])[0],
            "launches": alaunches}
    row = {"phase": "disagg_wire", "dtype": "bfloat16",
           "transport": "threaded",
           "prompt": len(prompt), "max_tokens": budget,
           "bundle_bytes": hop["bundle_bytes"],
           "kv_bytes_migrated": int(hop["attach_head"]["x-kv-bytes-migrated"]),
           "ttft_ms": 1e3 * hop["frames"][-1]["ttft_s"],
           "streamed_equal_inproc": streamed == inproc,
           "first_mismatch": _first_mismatches([streamed], [inproc])[0],
           "wrong_dtype": [wrong_dtype[0], wrong_dtype[2].decode()[:200]],
           "dtype_rejections": after - before,
           "wrong_role": [wrong_role[0], wrong_role[2].decode()[:200]],
           "launches": launches}
    emit(row)
    emit(arow)
    _require(launches, ("flash_fwd", "paged_decode"), "disagg_wire")
    if launches["flash_fwd"] != cfg.n_layers:
        raise AssertionError(f"the hop launched K3 {launches['flash_fwd']} "
                             f"times, want {cfg.n_layers} (the export)")
    if streamed != inproc:
        raise AssertionError(f"the two hops streamed {streamed}, the same "
                             f"hop in process gives {inproc}")
    if wrong_dtype[0] != 400 or b"dtype" not in wrong_dtype[2] \
            or after != before + 1:
        raise AssertionError(f"int8 bundle on the bf16 pool: {wrong_dtype[0]}"
                             f" {wrong_dtype[2][:200]}, rejections "
                             f"{before} → {after}")
    if wrong_role[0] != 400 or b"role" not in wrong_role[2]:
        raise AssertionError(f":attach on the prefill-role server: "
                             f"{wrong_role[0]} {wrong_role[2][:200]}")
    _require(alaunches, ("flash_fwd", "paged_decode"), "disagg_wire (async)")
    if alaunches["flash_fwd"] != cfg.n_layers:
        raise AssertionError(f"the async hop launched K3 "
                             f"{alaunches['flash_fwd']} times, want "
                             f"{cfg.n_layers} (the export)")
    if astreamed != streamed \
            or arow["kv_bytes_migrated"] != row["kv_bytes_migrated"]:
        raise AssertionError(
            f"the async hop streamed {astreamed} with "
            f"{arow['kv_bytes_migrated']} bytes migrated, the threaded "
            f"hop {streamed} with {row['kv_bytes_migrated']}")
    return {"threaded": row, "async": arow}


# ------------------------------------------------------------ unary predict

PREDICT_CLIENTS = 8          # keep-alive clients of the x-tensor traffic
PREDICT_PER_CLIENT = 4       # requests each, one 224 x 224 x 3 image each
PREDICT_SEQUENTIAL = 4       # JSON and b64 requests, one after another
PREDICT_STREAM_LINES = 32
PREDICT_FP32_ROWS = 4
PREDICT_BUDGET = 1.5         # predict_residency's budget, in models
PREDICT_MEMORY_SHARE = 0.9   # of a model's bytes an eviction must free
PREDICT_CANARY_SEED = 0
PREDICT_CANARY_REQUESTS = 16
PREDICT_INT8_SHARE = 0.3     # int8 resident bytes of the bf16 model's, most
PREDICT_DEVICE_MS = 5        # predict_cmd's MODEL_DEVICE_MS
PREDICT_CMD_REQUESTS = 10    # per client of the fake device, 8 clients
#: knobs predict_cmd's replicas get besides the phase's own (none: the
#: card; a CPU rehearsal names ``GEN_DEVICE=cpu`` here)
PREDICT_CMD_ENV = {}
#: the module predict_cmd's MODEL_MODULE replica imports: its model
#: refuses an input that is not on the card
PREDICT_MODULE = '''
def register(server):
    def tripled(x):
        if x.device.type != "cuda":
            raise RuntimeError(f"input on {x.device}, not the card")
        return x * 3.0
    server.register("tripled", tripled, version=3)
'''


def resnet_predict(cfg):
    """``bench.py:268-287``'s two predict functions over a ``(params,
    stats)`` tree: eval logits in the config's compute dtype, softmax,
    fp32 out; the int8 variant widens ``quantize_tree``'s codes to bf16
    at the call (``dequantize_tree``), its classifier weight then to
    fp32, as JAX's head promotes it."""
    import torch
    from kubeflow_tpu_torch.compute import quantize
    from kubeflow_tpu_torch.compute.models import resnet

    def predict(tree, x):
        params, stats = tree
        logits, _ = resnet.apply(params, stats, x, cfg, train=False)
        return torch.softmax(logits, dim=-1).float()

    def predict_int8(tree, x):
        qparams, stats = tree
        params = quantize.dequantize_tree(qparams, dtype=torch.bfloat16)
        params["fc"] = {k: v.float() for k, v in params["fc"].items()}
        return predict((params, stats), x)

    return predict, predict_int8


def predict_images(n, seed=20):
    return np.random.default_rng(seed).standard_normal(
        (n, 224, 224, 3)).astype(np.float32)


def _x_tensor(x):
    return x.tobytes(), {"Content-Type": "application/x-tensor",
                         "X-Tensor-Dtype": str(x.dtype),
                         "X-Tensor-Shape": ",".join(map(str, x.shape))}


def _b64_body(x):
    import base64
    return json.dumps({"tensor": {
        "dtype": str(x.dtype), "shape": list(x.shape),
        "b64": base64.b64encode(x.tobytes()).decode()}}).encode()


def _predict_post(conn, path, body, headers=None):
    """One request on a kept-alive connection → ``{"status", "head",
    "body", "ms"}`` (the client's wall ms, the body read)."""
    t0 = time.perf_counter()
    conn.request("POST", path, body,
                 headers or {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    return {"status": resp.status, "body": data,
            "head": {k.lower(): v for k, v in resp.getheaders()},
            "ms": 1e3 * (time.perf_counter() - t0)}


def _predict_rows(r, classes):
    """A 200 answer → its rows ``[n, classes]`` in any of the formats."""
    if r["status"] != 200:
        raise AssertionError(f"predict answered {r['status']}: "
                             f"{r['body'][:300]!r}")
    ctype = r["head"].get("content-type")
    if ctype == "application/x-tensor":
        if r["head"].get("x-tensor-dtype") != "float32":
            raise AssertionError(f"X-Tensor-Dtype {r['head']}")
        shape = [int(d) for d in r["head"]["x-tensor-shape"].split(",")]
        return np.frombuffer(r["body"], "<f4").reshape(shape)
    if ctype != "application/json":
        raise AssertionError(f"Content-Type {ctype!r}")
    payload = json.loads(r["body"])
    if "tensor" in payload:
        import base64
        t = payload["tensor"]
        return np.frombuffer(base64.b64decode(t["b64"]), "<f4").reshape(
            t["shape"])
    return np.asarray(payload["predictions"], np.float32).reshape(
        -1, classes)


def _parallel(fns):
    """Run each callable on a thread of its own → their results; the
    first error raised in any is raised here."""
    import threading
    out, errors = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    return out


def occupancy_delta(before, after):
    """Two reads of one ``serving_batch_occupancy_requests`` series →
    ``(dispatches, requests, mean requests a dispatch)`` between them."""
    before = before or {"sum": 0.0, "count": 0}
    calls = after["count"] - before["count"]
    reqs = after["sum"] - before["sum"]
    return calls, reqs, reqs / calls if calls else 0.0


def check_coalesced(device_calls, requests, occupancy_mean):
    """Concurrent requests must share device calls: fewer calls than
    requests, and more than one request a dispatch on average."""
    if not device_calls < requests or not occupancy_mean > 1.0:
        raise AssertionError(
            f"{requests} concurrent requests took {device_calls} device "
            f"calls, mean occupancy {occupancy_mean}: nothing coalesced")


def check_memory_drop(before, after, model_bytes,
                      share=PREDICT_MEMORY_SHARE):
    """An eviction must free the model's device memory: allocated bytes
    fall by at least ``share`` of its bytes."""
    if before - after < share * model_bytes:
        raise AssertionError(
            f"the eviction freed {before - after} bytes of "
            f"{model_bytes}, less than {share} of them")


def canary_split(seed, weight, n, stable, canary):
    """The versions ``n`` requests get from a server whose
    ``_canary_rng`` is ``random.Random(seed)``: the canary where a draw
    falls below ``weight`` (``ModelServer._route``)."""
    import random
    rng = random.Random(seed)
    return [canary if rng.random() < weight else stable for _ in range(n)]


def _latency(ms):
    return {"p50_ms": _pctl(ms, 0.5), "p99_ms": _pctl(ms, 0.99),
            "n": len(ms)}


PREDICT_RATIO_KEYS = ("images_per_s.binary", "images_per_s.json",
                      "images_per_s.b64", "latency.binary.p50_ms",
                      "latency.binary.p99_ms", "inference_time_ms_p50",
                      "occupancy_mean")
#: what the async transport answers a ``:predictStream`` (JAX's words)
PREDICT_STREAM_501 = (b'{"error": "predictStream requires the threaded '
                      b'transport (SERVING_TRANSPORT=threaded)"}')


def _predict_traffic(port, imgs, model):
    """The unary traffic over one listener: 8 keep-alive clients send 4
    ``application/x-tensor`` requests each of one image together, then 4
    JSON ``instances`` and 4 b64 requests one after another on one
    connection → dict of the answers, the wall seconds of the x-tensor
    traffic and the model's device calls and occupancy over it."""
    import http.client
    from kubeflow_tpu_torch.compute import serving
    path = "/v1/models/resnet50:predict"
    occ0 = serving._BATCH_OCCUPANCY.samples().get(("resnet50", "stable"))
    calls0 = model.device_calls

    def client(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            return [_predict_post(conn, path, *_x_tensor(imgs[i:i + 1]))
                    for _ in range(PREDICT_PER_CLIENT)]
        finally:
            conn.close()

    t0 = time.perf_counter()
    binary = _parallel([lambda i=i: client(i)
                        for i in range(PREDICT_CLIENTS)])
    binary_s = time.perf_counter() - t0
    calls = model.device_calls - calls0
    dispatches, coalesced, occ_mean = occupancy_delta(
        occ0, serving._BATCH_OCCUPANCY.samples()[("resnet50", "stable")])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        json_r = [_predict_post(conn, path, json.dumps(
            {"instances": imgs[:1].tolist()}).encode())
            for _ in range(PREDICT_SEQUENTIAL)]
        b64_r = [_predict_post(conn, path, _b64_body(imgs[:1]))
                 for _ in range(PREDICT_SEQUENTIAL)]
    finally:
        conn.close()
    return {"binary": binary, "binary_s": binary_s, "calls": calls,
            "dispatches": dispatches, "coalesced": coalesced,
            "occ_mean": occ_mean, "json": json_r, "b64": b64_r}


def _predict_errors(run, ref, classes):
    """Each format's answers against the in-process rows → {format:
    [max |Δ| a request]}; an x-tensor answer must carry its shape, the
    served version and ``X-Inference-Time-Ms``."""
    errs = {}
    for i, rs in enumerate(run["binary"]):
        for r in rs:
            head = r["head"]
            if head.get("x-tensor-shape") != f"1,{classes}" \
                    or head.get("x-served-version") != "1" \
                    or "x-inference-time-ms" not in head:
                raise AssertionError(f"x-tensor answer headers: {head}")
            errs.setdefault("binary", []).append(float(np.abs(
                _predict_rows(r, classes)[0] - ref[i]).max()))
    for fmt in ("json", "b64"):
        for r in run[fmt]:
            errs.setdefault(fmt, []).append(float(np.abs(
                _predict_rows(r, classes)[0] - ref[0]).max()))
    return errs


def _predict_numbers(run):
    """Images/s and latency p50/p99 per format, the
    ``X-Inference-Time-Ms`` p50 and the coalescing of one run."""
    n = PREDICT_CLIENTS * PREDICT_PER_CLIENT
    x_ms = [float(r["head"]["x-inference-time-ms"])
            for rs in run["binary"] for r in rs]
    return {"requests": n, "device_calls": run["calls"],
            "occupancy_dispatches": run["dispatches"],
            "occupancy_requests": run["coalesced"],
            "occupancy_mean": run["occ_mean"],
            "images_per_s": {
                "binary": n / run["binary_s"],
                "json": 1e3 * len(run["json"]) / sum(
                    r["ms"] for r in run["json"]),
                "b64": 1e3 * len(run["b64"]) / sum(
                    r["ms"] for r in run["b64"])},
            "latency": {fmt: _latency([r["ms"] for r in (
                [r for rs in run["binary"] for r in rs]
                if fmt == "binary" else run[fmt])])
                for fmt in ("binary", "json", "b64")},
            "inference_time_ms_p50": _pctl(x_ms, 0.5)}


def check_predict_errors(errs, transport):
    """Every format's rows over ``transport`` within bf16's tolerance of
    the in-process predict, and finite."""
    for fmt, e in errs.items():
        if max(e) > TOL["bfloat16"] or not np.isfinite(e).all():
            raise AssertionError(
                f"{fmt} rows over the {transport} transport {max(e)} off "
                f"the in-process predict (tolerance {TOL['bfloat16']})")


def phase_predict(kernel_fns):
    """ResNet-50 (bf16, 1000 classes, ``init_params`` from a seed, as
    ``bench.py:266`` serves it) behind the port's ``ModelServer`` on
    127.0.0.1, registered as
    ``resnet50`` and ``resnet50-int8`` (weight-only int8, widened at the
    call; both residency-managed, preloaded) with ``bench.py:268-287``'s
    predict functions, and an fp32 ResNet-50 (TF32 off) on the same
    weights. The server listens on both transports (``TRANSPORTS``); the
    x-tensor traffic's concurrency runs once in process through the
    batcher, then the same traffic runs over each transport
    (``_predict_traffic``), counts zeroed just before it and read after:
    8 keep-alive clients send 4 ``application/x-tensor`` requests each of
    one 224 x 224 x 3 float32 image, then 4 JSON ``instances`` and 4 b64
    requests one after another. Over the threaded transport then one ``:predictStream`` of
    32 b64 lines, 8 images to the int8 model and 4 to the fp32 one; over
    the async one ``:predictStream`` answers 501 with JAX's words. Every
    answer is 200 in its format; every served row is within 2e-2 of the
    in-process predict of the same image (bf16), the fp32 rows within
    1e-4 of ``resnet.apply`` unpadded; the x-tensor requests coalesce on
    each transport (fewer device calls than requests, mean occupancy
    above 1); the int8 model holds at most 0.3x the bf16 model's bytes,
    its argmax agreement is printed. Images/s and latency p50/p99 per
    format, the ``X-Inference-Time-Ms`` p50 and occupancy per transport
    (one row each, then their ratios), and one batch of 8 profiled. →
    {transport: row}"""
    import dataclasses
    import http.client
    import torch
    from kubeflow_tpu_torch.compute import profiler, quantize, serving
    from kubeflow_tpu_torch.compute.models import resnet
    cfg = resnet.Config(depth=50, n_classes=1000, dtype="bfloat16")
    classes = cfg.n_classes
    predict, predict_int8 = resnet_predict(cfg)
    f32_predict, _ = resnet_predict(dataclasses.replace(cfg,
                                                        dtype="float32"))
    host = resnet.init_params(cfg, torch.Generator().manual_seed(20),
                              device="cpu")
    server = serving.ModelServer()
    model = server.register_loadable("resnet50", predict, host,
                                     preload=True)
    qmodel = server.register_loadable(
        "resnet50-int8", predict_int8,
        (quantize.quantize_tree(host[0]), host[1]), preload=True)
    dev_tree = model._dev_params
    server.register("resnet50-fp32", lambda x: f32_predict(dev_tree, x))
    ports = {t: server.start(port=0, host="127.0.0.1", transport=t)
             for t in TRANSPORTS}
    imgs = predict_images(PREDICT_CLIENTS)
    runs, launches = {}, {}
    try:
        # the in-process answer of every image (bucket 8), and every
        # bucket the traffic lands on launched once before it
        ref = model._run(imgs)
        for n in (1, PREDICT_STREAM_LINES):
            model._run(np.repeat(imgs[:1], n, 0))
        torch.cuda.synchronize()
        # the first concurrent pass through the batcher reads ~1.7x fewer
        # images/s than the next, whichever transport carries it: one
        # pass in process first, so each transport is measured warm
        _parallel([lambda i=i: [model.predict_raw(imgs[i:i + 1])
                                for _ in range(PREDICT_PER_CLIENT)]
                   for i in range(PREDICT_CLIENTS)])
        x32 = imgs[:PREDICT_FP32_ROWS]
        for t in TRANSPORTS:
            _zero(kernel_fns)
            runs[t] = _predict_traffic(ports[t], imgs, model)
            conn = http.client.HTTPConnection("127.0.0.1", ports[t],
                                              timeout=300)
            try:
                if t == "async":
                    async_stream = _predict_post(
                        conn, "/v1/models/resnet50:predictStream",
                        _b64_body(imgs[:1]) + b"\n",
                        {"Content-Type": "application/x-ndjson"})
                else:
                    lines = [imgs[i % PREDICT_CLIENTS][None]
                             for i in range(PREDICT_STREAM_LINES)]
                    stream = _predict_post(
                        conn, "/v1/models/resnet50:predictStream",
                        b"\n".join(_b64_body(x) for x in lines) + b"\n",
                        {"Content-Type": "application/x-ndjson"})
                    int8_r = _predict_post(
                        conn, "/v1/models/resnet50-int8:predict",
                        *_x_tensor(imgs))
                    f32_r = _predict_post(
                        conn, "/v1/models/resnet50-fp32:predict",
                        *_x_tensor(x32))
            finally:
                conn.close()
            launches[t] = _launches(kernel_fns)
        with torch.inference_mode():
            f32_ref = f32_predict(dev_tree, torch.from_numpy(x32).cuda()) \
                .cpu().numpy()
        # one batch of 8, profiled: upload, forward, fetch
        with profiler.trace("build/profile") as cap:
            w0 = time.perf_counter()
            model._run(imgs)
            wall_ms = 1e3 * (time.perf_counter() - w0)
        prof = profiler.device_summary(cap.profile, wall_ms)
        listing = json.loads(_http(ports["threaded"], "GET",
                                   "/v1/models")[2])
    finally:
        server.stop()
    errs = {t: _predict_errors(runs[t], ref, classes) for t in TRANSPORTS}
    if stream["status"] != 200 or stream["head"].get("content-type") \
            != "application/x-ndjson":
        raise AssertionError(f":predictStream {stream['status']} "
                             f"{stream['head']}")
    frames = [json.loads(ln) for ln in stream["body"].splitlines() if ln]
    if len(frames) != PREDICT_STREAM_LINES:
        raise AssertionError(f":predictStream gave {len(frames)} frames")
    for i, f in enumerate(frames):
        if "tensor" not in f:
            raise AssertionError(f"stream frame {i}: {str(f)[:200]}")
        errs["threaded"].setdefault("stream", []).append(float(np.abs(
            _predict_rows({"status": 200, "head": {
                "content-type": "application/json"},
                "body": json.dumps(f).encode()}, classes)[0]
            - ref[i % PREDICT_CLIENTS]).max()))
    int8_rows = _predict_rows(int8_r, classes)
    f32_rows = _predict_rows(f32_r, classes)
    ratio = qmodel.resident_bytes / model.resident_bytes
    rows = {}
    for t in TRANSPORTS:
        numbers = _predict_numbers(runs[t])
        row = {"phase": "predict", "model": "resnet50", "dtype": "bfloat16",
               "transport": t, "image": [224, 224, 3],
               "clients": PREDICT_CLIENTS, "per_client": PREDICT_PER_CLIENT,
               **numbers,
               "max_abs_err": {k: max(v) for k, v in errs[t].items()},
               "launches": launches[t]}
        if t == "threaded":
            row["images_per_s"]["stream"] = \
                1e3 * PREDICT_STREAM_LINES / stream["ms"]
            row["latency"]["stream_ms"] = stream["ms"]
            row.update({
                "fp32_max_abs_err": float(np.abs(f32_rows - f32_ref).max()),
                "int8_resident_bytes": qmodel.resident_bytes,
                "bf16_resident_bytes": model.resident_bytes,
                "int8_bytes_share": ratio,
                "int8_argmax_agreement": float(
                    (int8_rows.argmax(-1) == ref.argmax(-1)).mean()),
                "int8_max_abs_diff": float(np.abs(int8_rows - ref).max()),
                "resident_bytes": listing["resident_bytes"]})
        else:
            row["predict_stream"] = [async_stream["status"],
                                     async_stream["body"].decode()[:200]]
        emit(row)
        rows[t] = row
    emit({"phase": "predict_transports", "async_over_threaded":
          transport_ratios(rows, PREDICT_RATIO_KEYS)})
    emit({"phase": "predict_profile", "trace": cap.path, "rows": 8, **prof})
    for t in TRANSPORTS:
        check_predict_errors(errs[t], t)
        check_coalesced(runs[t]["calls"],
                        PREDICT_CLIENTS * PREDICT_PER_CLIENT,
                        runs[t]["occ_mean"])
    f32_err = rows["threaded"]["fp32_max_abs_err"]
    if not f32_err <= TOL["float32"]:
        raise AssertionError(f"fp32 rows {f32_err} off resnet.apply "
                             f"(tolerance {TOL['float32']})")
    if not np.allclose(np.concatenate([ref, f32_rows, int8_rows])
                       .sum(-1), 1.0, atol=1e-3):
        raise AssertionError("predicted rows do not sum to 1")
    if ratio > PREDICT_INT8_SHARE:
        raise AssertionError(f"resnet50-int8 holds {ratio} of the bf16 "
                             f"model's bytes (at most {PREDICT_INT8_SHARE})")
    if (async_stream["status"], async_stream["body"]) \
            != (501, PREDICT_STREAM_501):
        raise AssertionError(f":predictStream over async answered "
                             f"{async_stream['status']} "
                             f"{async_stream['body'][:200]!r}")
    return rows


def phase_predict_residency():
    """Two managed ResNet-50s (bf16, weights from two seeds, host trees
    on the CPU) under ``budget_bytes`` = 1.5 models: a predict on ``a``
    loads it, one on ``b`` evicts ``a`` — ``torch.cuda.memory_allocated``
    falls by at least 0.9x ``a``'s bytes across the unload —, and the
    next on ``a`` reloads it (loads 2). Then, the budget raised to three
    models, a canary of ``a`` (``b``'s weights, version 2) at weight 0.5
    with ``_canary_rng`` seeded: ``X-Served-Version`` of 16 requests is
    the split the seed dictates; ``promote_canary`` serves version 2
    alone; a version-3 canary at weight 1 serves 3 alone and
    ``rollback_canary`` returns every request to 2, the canary's memory
    freed."""
    import http.client
    import random
    import torch
    from kubeflow_tpu_torch.compute import serving
    from kubeflow_tpu_torch.compute.models import resnet
    cfg = resnet.Config(depth=50, n_classes=1000, dtype="bfloat16")
    predict, _ = resnet_predict(cfg)
    host_a, host_b = (resnet.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")
        for seed in (22, 23))
    one = serving.tree_bytes(host_a)
    server = serving.ModelServer(budget_bytes=int(PREDICT_BUDGET * one))
    server._canary_rng = random.Random(PREDICT_CANARY_SEED)
    a = server.register_loadable("a", predict, host_a)
    b = server.register_loadable("b", predict, host_b)
    port = server.start(port=0, host="127.0.0.1")
    drops = []
    unload = a.unload

    def measured_unload():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        unload()
        drops.append((before, torch.cuda.memory_allocated()))

    a.unload = measured_unload
    body, headers = _x_tensor(predict_images(1, seed=24))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)

    def served(name):
        r = _predict_post(conn, f"/v1/models/{name}:predict", body, headers)
        _predict_rows(r, cfg.n_classes)
        return r["head"]["x-served-version"]

    try:
        t0 = time.perf_counter()
        served("a")
        first_ms = 1e3 * (time.perf_counter() - t0)
        served("b")                     # evicts a
        listing_b = json.loads(_http(port, "GET", "/v1/models")[2])
        t0 = time.perf_counter()
        served("a")                     # reloads a, evicts b
        reload_ms = 1e3 * (time.perf_counter() - t0)
        a.unload = unload
        listing_a = json.loads(_http(port, "GET", "/v1/models")[2])
        server.budget_bytes = int(3 * one)
        server.register_canary("a", predict, host_b, version=2, weight=0.5)
        split = [served("a") for _ in range(PREDICT_CANARY_REQUESTS)]
        want = canary_split(PREDICT_CANARY_SEED, 0.5,
                            PREDICT_CANARY_REQUESTS, "1", "2")
        server.promote_canary("a")
        promoted = [served("a") for _ in range(4)]
        server.register_canary("a", predict, host_a, version=3, weight=1.0)
        canary3 = [served("a") for _ in range(4)]
        torch.cuda.synchronize()
        before_rollback = torch.cuda.memory_allocated()
        server.rollback_canary("a")
        after_rollback = torch.cuda.memory_allocated()
        rolled = [served("a") for _ in range(4)]
        listing_end = json.loads(_http(port, "GET", "/v1/models")[2])
    finally:
        conn.close()
        server.stop()
    row = {"phase": "predict_residency", "model_bytes": one,
           "budget_bytes": int(PREDICT_BUDGET * one),
           "evictions_measured": len(drops),
           "eviction_freed_bytes": [x - y for x, y in drops],
           "a_loads": a.loads, "a_evictions": a.evictions,
           "b_evictions": b.evictions,
           "states_after_b": {m["name"]: m["state"]
                              for m in listing_b["models"]},
           "states_after_a": {m["name"]: m["state"]
                              for m in listing_a["models"]},
           "first_predict_ms": first_ms, "reload_predict_ms": reload_ms,
           "canary_split": "".join(split), "canary_want": "".join(want),
           "promoted": promoted, "canary3": canary3, "rolled_back": rolled,
           "rollback_freed_bytes": before_rollback - after_rollback,
           "resident_bytes_end": listing_end["resident_bytes"]}
    emit(row)
    if not drops:
        raise AssertionError("a predict on b did not evict a")
    check_memory_drop(*drops[0], one)
    check_memory_drop(before_rollback, after_rollback, one)
    if a.loads != 2 or row["states_after_b"] != {"a": "EVICTED",
                                                 "b": "RESIDENT"} \
            or row["states_after_a"] != {"a": "RESIDENT", "b": "EVICTED"}:
        raise AssertionError(f"residency: loads {a.loads}, "
                             f"{row['states_after_b']}, "
                             f"{row['states_after_a']}")
    if split != want or set(split) != {"1", "2"}:
        raise AssertionError(f"canary split {split}, the seed says {want}")
    if set(promoted) != {"2"} or set(canary3) != {"3"} \
            or set(rolled) != {"2"}:
        raise AssertionError(f"promote {promoted}, canary {canary3}, "
                             f"rollback {rolled}")
    return row


def phase_predict_cmd():
    """``python -m kubeflow_tpu_torch.cmd model-server`` without
    ``MODEL_GENERATE`` and without ``GEN_DEVICE`` (the card), three
    replicas started together: the stock MLP (``/healthz``,
    ``/v1/models/default``, a JSON predict whose 16-class rows sum to
    1); ``MODEL_DEVICE_MS=5``, 8 keep-alive clients of 10 one-row
    requests, the rows/s printed beside 1000/5; ``MODEL_MODULE`` naming
    a module this phase writes under ``build/`` on ``PYTHONPATH``, whose
    model refuses an input that is not on the card. The MLP replica and a
    second ``MODEL_DEVICE_MS=5`` one run ``SERVING_TRANSPORT=async`` (as
    the ModelDeployment controller renders a replica), the others the
    threaded default; each log names its transport, and the fake device's
    rows/s are printed for both. SIGTERM ends each with exit 0 within 30
    s."""
    import http.client
    import pathlib
    import signal
    root = pathlib.Path(__file__).resolve().parent
    moddir = _scratch("predict_module_")
    with open(f"{moddir}/predict_module.py", "w") as f:
        f.write(PREDICT_MODULE)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("GEN_", "MODEL_")) and k not in (
               "QOS_TENANTS", "SERVING_TRANSPORT")}
    env.update(PORT="0", HOST="127.0.0.1", OBS_EXPORT_DIR="",
               PYTHONPATH=str(root), **PREDICT_CMD_ENV)
    transports = {"mlp": "async", "sleeper": "threaded",
                  "sleeper_async": "async", "module": "threaded"}
    sleeper_env = {"MODEL_DEVICE_MS": str(PREDICT_DEVICE_MS)}
    extra = {"mlp": {}, "sleeper": sleeper_env,
             "sleeper_async": sleeper_env,
             "module": {"MODEL_MODULE": "predict_module",
                        "PYTHONPATH": f"{root}{os.pathsep}{moddir}"}}
    replicas = {k: _Replica({**env, **extra[k],
                             "SERVING_TRANSPORT": transports[k]}, root)
                for k in transports}
    try:
        ports = {k: r.port() for k, r in replicas.items()}
        startup = {k: time.perf_counter() - r.t0
                   for k, r in replicas.items()}
        status, _, body = _http(ports["mlp"], "GET", "/healthz")
        if (status, json.loads(body)) != (200, {"status": "ok"}):
            raise AssertionError(f"/healthz: {status} {body}")
        info = json.loads(_http(ports["mlp"], "GET",
                                "/v1/models/default")[2])
        x = np.random.default_rng(25).standard_normal((4, 64)).astype(
            np.float32)
        mlp = _http(ports["mlp"], "POST", "/v1/models/default:predict",
                    {"instances": x.tolist()})
        mlp_rows = np.asarray(json.loads(mlp[2])["predictions"])
        mod = _http(ports["module"], "POST", "/v1/models/tripled:predict",
                    {"instances": x.tolist()})
        one_row = _x_tensor(x[:1])

        def client(port):
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)
            try:
                return [_predict_post(conn, "/v1/models/default:predict",
                                      *one_row)
                        for _ in range(PREDICT_CMD_REQUESTS)]
            finally:
                conn.close()

        sleepers, sleeper_s = {}, {}
        for k in ("sleeper", "sleeper_async"):
            t0 = time.perf_counter()
            sleepers[k] = _parallel([lambda p=ports[k]: client(p)]
                                    * PREDICT_CLIENTS)
            sleeper_s[k] = time.perf_counter() - t0
        codes, t_term = {}, time.perf_counter()
        for r in replicas.values():
            r.proc.send_signal(signal.SIGTERM)
        for k, r in replicas.items():
            codes[k] = r.proc.wait(timeout=30)
        term_s = time.perf_counter() - t_term
    finally:
        for r in replicas.values():
            r.stop()
    rows = PREDICT_CLIENTS * PREDICT_CMD_REQUESTS
    row = {"phase": "predict_cmd", "transport": transports,
           "startup_s": startup,
           "mlp_status": mlp[0], "mlp_shape": list(mlp_rows.shape),
           "mlp_row_sums_max_err": float(np.abs(mlp_rows.sum(-1) - 1).max()),
           "mlp_residency": info.get("residency"),
           "module_status": mod[0],
           "module_version": mod[1].get("x-served-version"),
           "sleeper_rows": rows, "sleeper_s": sleeper_s["sleeper"],
           "sleeper_rows_per_s": rows / sleeper_s["sleeper"],
           "sleeper_async_s": sleeper_s["sleeper_async"],
           "sleeper_async_rows_per_s": rows / sleeper_s["sleeper_async"],
           "sleeper_capacity_rows_per_s": 1000 / PREDICT_DEVICE_MS,
           "sigterm_exit": codes, "sigterm_s": term_s}
    emit(row)
    if mlp[0] != 200 or mlp_rows.shape != (4, 16) \
            or row["mlp_row_sums_max_err"] > 1e-5:
        raise AssertionError(f"stock MLP: {mlp[0]} {mlp_rows.shape} "
                             f"{row['mlp_row_sums_max_err']}")
    if mod[0] != 200 or row["module_version"] != "3" or not np.allclose(
            json.loads(mod[2])["predictions"], x * 3.0, rtol=1e-6):
        raise AssertionError(f"MODEL_MODULE: {mod[0]} {mod[2][:300]!r}")
    for r in (r for k in sleepers for rs in sleepers[k] for r in rs):
        if r["status"] != 200 or not np.allclose(
                np.frombuffer(r["body"], "<f4"), x[0] * 2.0):
            raise AssertionError(f"MODEL_DEVICE_MS: {r['status']} "
                                 f"{r['body'][:200]!r}")
    if set(codes.values()) != {0}:
        raise AssertionError(f"SIGTERM exit codes {codes}: " + str(
            {k: r.log[-10:] for k, r in replicas.items()}))
    for k, r in replicas.items():
        check_transport_log(r.log, transports[k])
    return row


TRAIN_BATCH = (16, 1024)
TRAIN_WARM, TRAIN_TIMED = 2, 5
MESH_TP = 2
MESH_BUDGET = 8          # blocks per shard in the capacity check


def _locked_submit(eng, reqs):
    """Submit ``reqs`` while holding the engine's lock, so that its
    thread finds them queued together and admits them in order → the
    handles. Engines given the same requests this way run one schedule
    (admissions, block allocation, batches), so their pools compare
    byte for byte."""
    with eng._cond:
        return [eng.submit(p, max_tokens=m) for p, m in reqs]


def _mesh_run(eng, reqs, kernel_fns):
    """Warm ``eng`` up, zero the launch counts, run ``reqs`` on one
    locked schedule → (tokens per request, launches, stats before, stats
    after, wall s)."""
    eng.generate([1, 2, 3], max_tokens=2)
    _zero(kernel_fns)
    s0 = dict(eng.stats)
    t0 = time.perf_counter()
    outs = [h.result(timeout=600) for h in _locked_submit(eng, reqs)]
    wall = time.perf_counter() - t0
    _check_served(reqs, outs, eng.config.vocab_size)
    return ([o for o, _ in outs], _launches(kernel_fns), s0,
            dict(eng.stats), wall)


def _same_pool(a, b):
    """Two engines' pools (``engine._cache``, or a sharded engine's
    ``joined_pool_copy()``) hold the same bytes."""
    return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))


def check_tp_identity(main):
    """The tp 2 engine's 12 bf16 streams and pool equal the unsharded
    engine's (with the split rule at the model's KV heads, as the engine
    passes ``split_heads``), and with the shards' own split count the
    pool is not: the check would see the engine drop ``split_heads``."""
    if not (main["tp2_tokens_equal"] and main["tp2_pool_bytes_equal"]):
        raise AssertionError(f"the tensor=2 mesh left the unsharded "
                             f"engine: {main}")
    if main["tp2_local_splits_pool_bytes_equal"]:
        raise AssertionError("with the shards' own split count the tp 2 "
                             "pool still equals the unsharded one: the "
                             "identity check cannot see split_heads")


def check_export_copy(peak_extra, pool_bytes):
    """An export from a sharded pool copies only its own blocks: the
    device memory it adds at its peak stays under half the pool's
    bytes, where a copy of the whole pool would take all of them."""
    if peak_extra >= pool_bytes / 2:
        raise AssertionError(f"the export's peak allocation {peak_extra} "
                             f"bytes reaches half the {pool_bytes}-byte "
                             f"pool: it copied the pool")


def check_tp_launches(sharded, unsharded, expected, tp):
    """Each kernel of ``expected`` (name → the unsharded engine's count)
    launched exactly that often unsharded and ``tp`` times that often on
    the sharded engine: one launch a shard."""
    bad = {n: (sharded[n], unsharded[n], want)
           for n, want in expected.items()
           if unsharded[n] != want or sharded[n] != tp * want}
    if bad:
        raise AssertionError(f"launches (sharded, unsharded, expected "
                             f"unsharded) at tp {tp}: {bad}")


def check_pool_doubling(peaks, per_chip, shard_bytes, budget, tp):
    """The capacity claim at a fixed per-shard budget: both engines book
    ``budget`` blocks a shard and one shard of the ``tp`` pool holds the
    bytes of the whole unsharded pool, and the sharded engine reaches
    ``tp`` times the unsharded peak occupancy."""
    if per_chip != {1: budget, tp: budget}:
        raise AssertionError(f"per-shard blocks {per_chip}, want {budget}")
    if shard_bytes[1] != shard_bytes[tp]:
        raise AssertionError(f"one shard's pool bytes {shard_bytes[tp]} "
                             f"!= the unsharded pool's {shard_bytes[1]}")
    if not peaks[1] or peaks[tp] != tp * peaks[1]:
        raise AssertionError(f"peak occupancy {peaks}: the {tp}-shard "
                             f"pool must admit {tp}x the sequences")


class local_splits:
    """While open, the pool reads' split rules (``decode_splits``,
    ``chunk_splits``) are evaluated at a shard's own KV heads — the
    count the engine passes as ``split_heads`` (the model's) over
    ``tp`` — as the wrappers would without ``split_heads``. The kernels
    and their launch counts are untouched."""

    def __init__(self, tp):
        self.tp = tp

    def __enter__(self):
        from kubeflow_tpu_torch.compute.ops import paged_attention as ops
        self.ops = ops
        self.saved = (ops.decode_splits, ops.chunk_splits)
        decode, chunk = self.saved
        ops.decode_splits = lambda slots, kv, *rest: decode(
            slots, kv // self.tp, *rest)
        ops.chunk_splits = lambda batch, seq, kv, *rest: chunk(
            batch, seq, kv // self.tp, *rest)
        return self

    def __exit__(self, *exc):
        self.ops.decode_splits, self.ops.chunk_splits = self.saved


def _mesh_logits(params, cfg, reqs, mesh, **kw):
    """A ``debug_logits`` engine's (tokens, per-step fp32 logits) for
    ``reqs`` (on ``mesh``, or unsharded on the card)."""
    from kubeflow_tpu_torch.compute import generate as gen_lib
    eng = gen_lib.GenerationEngine(
        params, cfg, max_slots=8, block_size=16, max_context=1024,
        prefix_cache=False, debug_logits=True, mesh=mesh,
        device=None if mesh is not None else "cuda",
        name=f"mesh-logits-{cfg.dtype}", **kw)
    try:
        handles = [eng.submit(p, max_tokens=m) for p, m in reqs]
        return [(h.result(timeout=600)[0], h.logits) for h in handles]
    finally:
        eng.close()


def _vs_oracle(got, oracle, atol, rtol, what):
    """Each request's logits against the oracle's up to the first step
    where its tokens leave the oracle's → per request (first mismatch,
    max |Δ|)."""
    from kubeflow_tpu_torch.compute import conformance
    out = []
    for (toks, logits), (want, rows) in zip(got, oracle):
        n = _first_mismatches([toks], [want])[0]
        upto = len(want) if n is None else n + 1
        div = conformance.assert_logits_close(
            logits[:upto], rows[:upto], atol=atol, rtol=rtol, what=what)
        out.append({"first_mismatch": n, "max_abs": div["atol"]})
    return out


def phase_mesh(params, kernel_fns):
    """The engine's tensor mesh on one card: ``mesh_for_generation(
    tensor=2, devices=[cuda:0, cuda:0])`` — two shards, each with 4 q and
    1 KV head of the bf16 flagship and half of every pool block — against
    the unsharded engine and a ``tensor=1`` mesh, with the engine
    phase's 12 requests on one locked schedule. Checked: tp 1 tokens and
    pool bytes equal the unsharded engine's; bf16 tp 2 tokens and pool
    bytes equal them too, with the shards' split count at the model's
    KV heads, and in a second run at their own the pool differs (so the
    check sees ``split_heads``); in fp32 at full width tp 2 tokens equal
    the unsharded engine's but at top-2 gaps below 1e-3, logits within
    1e-3 of the cache-free oracle; bf16 tp 2 and a ``row_shard`` engine
    within 0.2 / 0.1 of it; an export from tp 2 is the unsharded bundle
    byte for byte and allocates less than half the pool's bytes; K3 24
    a cold prefill, K2 24 a prefix hit, K1 24 a decode step, twice the
    unsharded counts; at 8 blocks a shard the tp 2 pool admits twice
    the sequences; a prefix + 256-token chunk schedule with the
    unsharded engine's tokens. Printed: decode-step ms sharded and
    unsharded, ``measure_collective_share()`` and
    ``collective_bytes_per_step()``, labelled as two shards on one card,
    which makes no speed claim."""
    import torch
    from kubeflow_tpu_torch.compute import device as device_lib
    from kubeflow_tpu_torch.compute import generate as gen_lib
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    t_phase = time.perf_counter()
    tp = MESH_TP
    card = device_lib.resolve("cuda:0")
    meshes = {1: mesh_lib.mesh_for_generation(tensor=1, devices=[card]),
              tp: mesh_lib.mesh_for_generation(tensor=tp,
                                               devices=[card] * tp)}
    cfg = flagship_config()
    kw = dict(max_slots=8, block_size=16, max_context=1024)
    reqs = requests(12, cfg.vocab_size)
    row = {"phase": "mesh", "tp": tp,
           "devices": [str(d) for d in meshes[tp].devices],
           "speed": "two shards on one card: no speed claim",
           "card": device_lib.card_identity()}

    def engine(mesh, name, **extra):
        return gen_lib.GenerationEngine(
            params, cfg, mesh=mesh, device=None if mesh else "cuda",
            name=name, **kw, **extra)

    flat = engine(None, "mesh-flat")
    sharded = engine(meshes[tp], "mesh-tp2")
    try:
        # -- tp 1: the unsharded engine byte for byte
        one = engine(meshes[1], "mesh-tp1")
        try:
            toks_flat, launch_flat, f0, f1, _ = _mesh_run(flat, reqs,
                                                          kernel_fns)
            toks_one = _mesh_run(one, reqs, kernel_fns)[0]
            same_pool_one = _same_pool(one._cache, flat._cache)
        finally:
            one.close()
        # -- tp 2: the main path's run
        toks_tp, launches, s0, s1, wall = _mesh_run(sharded, reqs,
                                                    kernel_fns)
        same_pool_tp = _same_pool(sharded.joined_pool_copy(), flat._cache)
        local = engine(meshes[tp], "mesh-local")
        try:
            with local_splits(tp):
                toks_local = _mesh_run(local, reqs, kernel_fns)[0]
            same_pool_local = _same_pool(local.joined_pool_copy(),
                                         flat._cache)
        finally:
            local.close()
        row["main"] = {
            "requests": len(reqs),
            "tokens": sum(len(t) for t in toks_tp),
            "tp1_tokens_equal": toks_one == toks_flat,
            "tp1_pool_bytes_equal": same_pool_one,
            "tp2_tokens_equal": toks_tp == toks_flat,
            "tp2_first_mismatch": _first_mismatches(toks_tp, toks_flat),
            "tp2_pool_bytes_equal": same_pool_tp,
            "tp2_local_splits_tokens_equal": toks_local == toks_flat,
            "tp2_local_splits_pool_bytes_equal": same_pool_local,
            "tp2_local_splits_first_mismatch": _first_mismatches(
                toks_local, toks_flat),
            "wall_s": wall,
            "decode_step_ms": 1e3 * (s1["decode_seconds_total"]
                                     - s0["decode_seconds_total"])
            / (s1["decode_steps"] - s0["decode_steps"]),
            "unsharded_decode_step_ms": 1e3 * (
                f1["decode_seconds_total"] - f0["decode_seconds_total"])
            / (f1["decode_steps"] - f0["decode_steps"]),
            "launches": launches, "unsharded_launches": launch_flat}
        if not (toks_one == toks_flat and same_pool_one):
            raise AssertionError(f"the tensor=1 mesh is not the unsharded "
                                 f"engine byte for byte: {row['main']}")
        check_tp_identity(row["main"])
        _require(launches, ("paged_decode", "flash_fwd"), "mesh")
        # one schedule: every launch of the unsharded run, once a shard
        check_tp_launches(launches, launch_flat, {
            n: launch_flat[n]
            for n in ("flash_fwd", "paged_decode", "paged_chunk")}, tp)
        # -- an export from the sharded pool is the single-chip bundle
        prompt = requests(5, cfg.vocab_size, seed=11)[4][0]   # 700 tokens
        pool_bytes = sum(c.numel() * c.element_size()
                         for sh in sharded._shards for c in sh.cache)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = sharded.prefill_export(prompt, max_tokens=8, timeout=600)
        torch.cuda.synchronize()
        peak_extra = torch.cuda.max_memory_allocated() - base
        b = flat.prefill_export(prompt, max_tokens=8, timeout=600)
        row["export"] = {
            "blocks": a["meta"]["n_blocks"],
            "page_bytes": a["meta"]["page_bytes"],
            "peak_extra_bytes": peak_extra, "pool_bytes": pool_bytes,
            "bytes_equal": a["meta"]["first_token"]
            == b["meta"]["first_token"] and all(
                _same_bits(x, y) for x, y in zip(a["pages"], b["pages"]))}
        # -- launches: a cold prefill, a prefix hit + one decode step
        rng = np.random.default_rng(12)
        cold = rng.integers(0, cfg.vocab_size, 40).tolist()
        hit = cold[:32] + rng.integers(0, cfg.vocab_size, 8).tolist()
        counts = {}
        for label, eng in (("tp", sharded), ("flat", flat)):
            for name, (p, m) in (("cold", (cold, 1)), ("hit", (hit, 2))):
                _zero(kernel_fns)
                eng.generate(p, max_tokens=m)
                counts[label, name] = _launches(kernel_fns)
        L = cfg.n_layers
        check_tp_launches(counts["tp", "cold"], counts["flat", "cold"],
                          {"flash_fwd": L, "paged_decode": 0,
                           "paged_chunk": 0}, tp)
        check_tp_launches(counts["tp", "hit"], counts["flat", "hit"],
                          {"flash_fwd": 0, "paged_chunk": L,
                           "paged_decode": L}, tp)
        row["launches_per_call"] = {
            f"{label}_{name}": {k: v for k, v in c.items()
                                if k in ("flash_fwd", "paged_chunk",
                                         "paged_decode")}
            for (label, name), c in counts.items()}
        row["collective_share"] = sharded.measure_collective_share()
        row["collective_bytes_per_step"] = \
            sharded.collective_bytes_per_step()
        row["mesh_view"] = sharded.mesh_view()
    finally:
        sharded.close()
        flat.close()
    # -- capacity at a fixed per-shard budget
    peaks, per_chip, shard_bytes = {}, {}, {}
    cap_reqs = [(np.random.default_rng(20 + i).integers(
        0, cfg.vocab_size, 48).tolist(), 16) for i in range(8)]
    for n, mesh in ((1, None), (tp, meshes[tp])):
        eng = gen_lib.GenerationEngine(
            params, cfg, mesh=mesh, device=None if mesh else "cuda",
            num_blocks=MESH_BUDGET * n, prefix_cache=False,
            name=f"mesh-cap{n}", **kw)
        try:
            eng.generate([1, 2, 3], max_tokens=2)
            eng.stats["peak_occupancy"] = 0
            for h in _locked_submit(eng, cap_reqs):
                h.result(timeout=600)
            peaks[n] = eng.stats["peak_occupancy"]
            per_chip[n] = eng.per_chip_blocks
            shard_bytes[n] = sum(c.numel() * c.element_size()
                                 for c in eng._shards[0].cache)
        finally:
            eng.close()
    row["capacity"] = {"budget_blocks_per_shard": MESH_BUDGET,
                       "peak_occupancy": peaks, "shard_pool_bytes":
                       shard_bytes[tp]}
    check_pool_doubling(peaks, per_chip, shard_bytes, MESH_BUDGET, tp)
    # -- prefix cache + chunked prefill on the mesh
    leads, rest, cold_reqs = cohort_requests(cfg.vocab_size, budget=8)
    batches = [[leads[0]], [rest[0], rest[1], (cold_reqs[0][0], 8)]]
    got = {}
    for n, mesh in ((1, None), (tp, meshes[tp])):
        eng = gen_lib.GenerationEngine(
            params, cfg, mesh=mesh, device=None if mesh else "cuda",
            prefill_chunk=256, name=f"mesh-prefix{n}", **kw)
        try:
            eng.generate([1, 2, 3], max_tokens=2)
            _zero(kernel_fns)
            s0 = dict(eng.stats)
            got[n] = _served(eng, batches)
            st = {k: eng.stats[k] - s0[k]
                  for k in ("prefix_hits", "prefills", "prefill_chunks")}
            if n == tp:
                prefix_launches = _launches(kernel_fns)
        finally:
            eng.close()
    row["prefix"] = {**st, "tokens_equal": got[tp] == got[1],
                     "first_mismatch": _first_mismatches(got[tp], got[1]),
                     "launches": prefix_launches}
    if st["prefix_hits"] < 2 or st["prefill_chunks"] <= st["prefills"]:
        raise AssertionError(f"mesh prefix run: {st}")
    _require(prefix_launches, ("paged_chunk", "paged_decode"), "mesh prefix")
    # -- fp32 at full width, and the tolerance tier against the oracle
    oracle_cfg = flagship_config("float32", "dense")
    short = [(p, 16) for p, _ in requests(4, cfg.vocab_size)]
    oracle = [gen_lib.reference_greedy_decode(params, oracle_cfg, p, m,
                                              collect_logits=True)
              for p, m in short]
    cfg32 = flagship_config("float32")
    tp32 = _mesh_logits(params, cfg32, short, meshes[tp])
    flat32 = _mesh_logits(params, cfg32, short, None)
    row["fp32"] = {
        "vs_unsharded": _agreement([t for t, _ in tp32],
                                   [t for t, _ in flat32],
                                   [lg for _, lg in flat32]),
        "vs_oracle": _vs_oracle(tp32, oracle, 1e-3, 1e-3,
                                "fp32 tp 2 engine vs fp32 oracle")}
    row["bf16_vs_oracle"] = _vs_oracle(
        _mesh_logits(params, cfg, short, meshes[tp]), oracle, 0.2, 0.1,
        "bf16 tp 2 engine vs fp32 oracle")
    row["row_shard_bf16_vs_oracle"] = _vs_oracle(
        _mesh_logits(params, cfg, short, meshes[tp], row_shard=True),
        oracle, 0.2, 0.1, "bf16 row_shard tp 2 engine vs fp32 oracle")
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if not row["export"]["bytes_equal"]:
        raise AssertionError("the tp 2 export is not the unsharded bundle")
    check_export_copy(row["export"]["peak_extra_bytes"],
                      row["export"]["pool_bytes"])
    if not row["prefix"]["tokens_equal"]:
        raise AssertionError(f"the tp 2 prefix + chunked run left the "
                             f"unsharded engine: {row['prefix']}")
    return {**row, "launches": launches}


def phase_train(kernel_fns):
    """The train path: the flagship at full width and depth, bf16,
    ``remat=False``, through ``init_state`` → ``make_train_step`` →
    ``fit`` over one repeated 16 x 1024 batch. Launch counts are zeroed
    just before ``fit`` and read just after; the step waits for the card
    so the telemetry and the step times are device-complete."""
    import torch
    from kubeflow_tpu_torch.compute import data, profiler, telemetry, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = flagship_config(remat=False)
    opt = train.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                               total_steps=100)
    state = train.init_state(functools.partial(transformer.init_params, cfg),
                             opt, device="cuda",
                             generator=torch.Generator().manual_seed(0))
    step = train.make_train_step(train.plain_loss(transformer.loss_fn, cfg),
                                 opt)

    def synced(state, batch):
        out = step(state, batch)
        torch.cuda.synchronize()
        return out

    B, S = TRAIN_BATCH
    batch = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=4))
    tokens = B * S
    flops_per_step = transformer.flops_per_token(cfg) * tokens
    peak = telemetry.peak_flops()
    tel = telemetry.TrainTelemetry("flagship-train",
                                   flops_per_step=flops_per_step, peak=peak)
    n_steps = TRAIN_WARM + TRAIN_TIMED
    marks, losses = [], []

    def on_step(n, metrics):
        marks.append(time.perf_counter())
        losses.append(metrics["loss"])

    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = train.fit(state, synced, itertools.repeat(batch, n_steps),
                               on_step=on_step, telemetry=tel)
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = [b - a for a, b in zip(marks[TRAIN_WARM - 1:],
                                    marks[TRAIN_WARM:])]
    step_ms = 1e3 * statistics.mean(step_s)
    # one more step, profiled (its launches are not the path's count)
    with profiler.trace("build/profile") as cap:
        w0 = time.perf_counter()
        state, _ = synced(state, data.to_device(batch, "cuda"))
        wall_ms = 1e3 * (time.perf_counter() - w0)
    prof = profiler.device_summary(cap.profile, wall_ms)
    row = {"phase": "train", "dtype": "bfloat16", "batch": B, "seq": S,
           "layers": cfg.n_layers, "remat": cfg.remat, "steps": n_steps,
           "timed_steps": TRAIN_TIMED, "first_step_s": marks[0] - t0,
           "step_ms": step_ms, "step_ms_each": [1e3 * x for x in step_s],
           "tokens_per_s": tokens / (step_ms / 1e3),
           "flops_per_token": transformer.flops_per_token(cfg),
           "peak_flops": peak,
           "mfu": flops_per_step / (step_ms / 1e3) / peak,
           "telemetry_mfu": tel.live_mfu(),
           "peak_memory_bytes": peak_mem, "losses": losses,
           "grad_norm": float(metrics["grad_norm"]),
           "launches": launches,
           "launches_per_step": {k: v / n_steps for k, v in launches.items()}}
    emit(row)
    emit({"phase": "train_profile", "trace": cap.path, **prof})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != cfg.n_layers * n_steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {n_steps} "
                f"steps, want {cfg.n_layers} a step")
    return row


def _grads(params, cfg, batch):
    """(loss, fp32 gradient of every leaf) of ``transformer.loss_fn``."""
    import torch
    from kubeflow_tpu_torch.compute import train
    from kubeflow_tpu_torch.compute.models import transformer
    tree = train.tree_map(lambda t: t.detach().clone().requires_grad_(),
                          params)
    leaves = train.tree_leaves(tree)
    loss, _ = transformer.loss_fn(tree, batch, cfg)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def _leaf_errors(got, want):
    """Per leaf: max |Δg| over that leaf's max |g|."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(got, want)]


def phase_train_conformance(kernel_fns):
    """fp32 (TF32 off) gradients through K3/K4/K5 against plain PyTorch
    autograd through dense attention (flagship width, 2 layers, batch
    2 x 1024), then remat against no remat at full depth."""
    import torch
    from kubeflow_tpu_torch.compute import data
    from kubeflow_tpu_torch.compute.models import transformer
    batch = data.to_device(next(data.synthetic_lm(2, 1024, 32768, seed=5)),
                           "cuda")
    cfg2 = flagship_config("float32", n_layers=2, remat=False)
    params = transformer.init_params(cfg2, torch.Generator().manual_seed(1),
                                     device="cuda")
    flash_loss, flash_g = _grads(params, cfg2, batch)
    dense_loss, dense_g = _grads(
        params, dataclasses.replace(cfg2, attention="dense"), batch)
    errs = _leaf_errors(flash_g, dense_g)
    loss_rel = abs(flash_loss - dense_loss) / abs(dense_loss)
    report = {"phase": "train_conformance",
              "flash_vs_dense": {"layers": 2, "batch": [2, 1024],
                                 "loss": [flash_loss, dense_loss],
                                 "loss_rel": loss_rel, "tol_loss": 1e-5,
                                 "leaf_rel_max": max(errs),
                                 "tol_leaf": 1e-3}}
    cfg12 = flagship_config("float32")
    params = transformer.init_params(cfg12, torch.Generator().manual_seed(2),
                                     device="cuda")
    runs = {}
    for remat in (False, True):
        for fn in kernel_fns.values():
            fn.launches = 0
        loss, g = _grads(params, dataclasses.replace(cfg12, remat=remat),
                         batch)
        torch.cuda.synchronize()
        runs[remat] = (loss, g, {n: kernel_fns[n].launches for n in
                                 ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv")})
    remat_errs = _leaf_errors(runs[True][1], runs[False][1])
    report["remat"] = {"layers": 12, "loss": [runs[True][0], runs[False][0]],
                       "leaf_rel_max": max(remat_errs), "tol_leaf": 1e-5,
                       "launches": {"remat": runs[True][2],
                                    "no_remat": runs[False][2]}}
    emit(report)
    if loss_rel > 1e-5 or max(errs) > 1e-3:
        raise AssertionError(f"flash gradients leave the dense ones: loss "
                             f"{loss_rel}, leaves {errs}")
    if max(remat_errs) > 1e-5:
        raise AssertionError(f"remat changes the gradients: {remat_errs}")
    want = {True: {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12},
            False: {"flash_fwd": 12, "flash_bwd_dq": 12,
                    "flash_bwd_dkv": 12}}
    for remat in (False, True):
        if runs[remat][2] != want[remat]:
            raise AssertionError(f"remat={remat} launches {runs[remat][2]}, "
                                 f"want {want[remat]}")
    return report


def moe_config(dtype="bfloat16", **kw):
    """The MoE flagship the JAX package measured (``hack/moe_lab.py``):
    vocab 32000, d_model 1024, 8 layers, 8 heads (MHA, head_dim 128), ff
    2816, 8 experts top-2, dropless on the grouped matmul (block_m 128),
    flash attention, per-layer weights, no remat."""
    from kubeflow_tpu_torch.compute.models import transformer
    fields = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8,
                  max_seq=1024, moe_experts=8, moe_top_k=2,
                  moe_dropless=True, moe_gmm="auto", moe_gmm_block_m=128,
                  scan_layers=False, remat=False, attention="flash")
    return transformer.Config(**{**fields, **kw}, dtype=dtype)


MOE_KERNELS = ("grouped_matmul", "grouped_matmul_dw", "flash_fwd",
               "flash_bwd_dq", "flash_bwd_dkv")


def phase_moe_apply(params, kernel_fns):
    """The MoE forward: ``transformer.apply`` of the MoE flagship (bf16)
    on 1 x 1024 tokens, counts zeroed just before and read just after:
    2 K6 and 1 K3 launch a layer, logits finite."""
    import torch
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = moe_config()
    toks = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq),
                         generator=torch.Generator().manual_seed(6)).cuda()
    with torch.no_grad():
        transformer.apply(params, toks, cfg)             # warm-up
        torch.cuda.synchronize()
        for fn in kernel_fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits = transformer.apply(params, toks, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    row = {"phase": "moe_apply", "dtype": "bfloat16",
           "tokens": [1, cfg.max_seq],
           "layers": cfg.n_layers, "experts": cfg.moe_experts,
           "top_k": cfg.moe_top_k, "wall_ms": 1e3 * wall,
           "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "launches": launches}
    emit(row)
    if not row["finite"] or tuple(logits.shape) != (1, cfg.max_seq,
                                                    cfg.vocab_size):
        raise AssertionError("MoE apply gave non-finite or misshapen logits")
    want = {"grouped_matmul": 2 * cfg.n_layers, "flash_fwd": cfg.n_layers}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"MoE apply launched {name} "
                                 f"{launches[name]} times, want {n}")
    return row


MOE_BATCH = (8, 1024)
MOE_WARM, MOE_TIMED = 2, 3


def phase_moe(kernel_fns):
    """The MoE paths: the forward (:func:`phase_moe_apply`) on the fresh
    weights, then training — the MoE flagship, bf16, ``remat=False``,
    ``init_state`` → ``make_train_step`` → ``fit`` over one repeated 8 x
    1024 ``synthetic_lm`` batch, 2 warm + 3 timed steps (lr 1e-3, warmup
    1); counts zeroed just before ``fit`` and read just after. Then one
    step profiled. → ``(apply row, train row)``."""
    import torch
    from kubeflow_tpu_torch.compute import data, profiler, telemetry, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = moe_config()
    opt = train.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                               total_steps=100)
    state = train.init_state(functools.partial(transformer.init_params, cfg),
                             opt, device="cuda",
                             generator=torch.Generator().manual_seed(0))
    apply_row = phase_moe_apply(state.params, kernel_fns)
    step = train.make_train_step(train.plain_loss(transformer.loss_fn, cfg),
                                 opt)

    def synced(state, batch):
        out = step(state, batch)
        torch.cuda.synchronize()
        return out

    B, S = MOE_BATCH
    batch = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=7))
    tokens = B * S
    assignments = tokens * cfg.moe_top_k
    bm = cfg.moe_gmm_block_m
    m_pad = (-(-assignments // bm) + cfg.moe_experts) * bm
    flops_per_step = transformer.flops_per_token(cfg) * tokens
    peak = telemetry.peak_flops()
    tel = telemetry.TrainTelemetry("moe-train", flops_per_step=flops_per_step,
                                   peak=peak)
    n_steps = MOE_WARM + MOE_TIMED
    marks, losses, auxs = [], [], []

    def on_step(n, metrics):
        marks.append(time.perf_counter())
        losses.append(metrics["loss"])
        auxs.append(metrics["moe_aux"])

    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = train.fit(state, synced, itertools.repeat(batch, n_steps),
                               on_step=on_step, telemetry=tel)
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    auxs = [float(x) for x in auxs]
    step_s = [b - a for a, b in zip(marks[MOE_WARM - 1:], marks[MOE_WARM:])]
    step_ms = 1e3 * statistics.mean(step_s)
    with profiler.trace("build/profile") as cap:
        w0 = time.perf_counter()
        state, _ = synced(state, data.to_device(batch, "cuda"))
        wall_ms = 1e3 * (time.perf_counter() - w0)
    prof = profiler.device_summary(cap.profile, wall_ms)
    row = {"phase": "moe_train", "dtype": "bfloat16", "batch": B, "seq": S,
           "layers": cfg.n_layers, "experts": cfg.moe_experts,
           "top_k": cfg.moe_top_k, "block_m": bm, "remat": cfg.remat,
           "params": transformer.param_count(cfg), "steps": n_steps,
           "timed_steps": MOE_TIMED, "first_step_s": marks[0] - t0,
           "step_ms": step_ms, "step_ms_each": [1e3 * x for x in step_s],
           "tokens_per_s": tokens / (step_ms / 1e3),
           "flops_per_token": transformer.flops_per_token(cfg),
           "mfu_formula": "JAX flops_per_token (dense MLP counted once)",
           "peak_flops": peak,
           "mfu": flops_per_step / (step_ms / 1e3) / peak,
           "telemetry_mfu": tel.live_mfu(),
           "peak_memory_bytes": peak_mem, "losses": losses,
           "moe_aux": auxs, "rows_padded": m_pad,
           "padded_row_share": (m_pad - assignments) / m_pad,
           "grad_norm": float(metrics["grad_norm"]),
           "launches": launches,
           "launches_per_step": {k: v / n_steps for k, v in launches.items()}}
    emit(row)
    emit({"phase": "moe_train_profile", "trace": cap.path, **prof})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE train loss did not fall: {losses}")
    want = {"grouped_matmul": 4 * cfg.n_layers,
            "grouped_matmul_dw": 2 * cfg.n_layers,
            "flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    for name, n in want.items():
        if launches[name] != n * n_steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {n_steps} MoE steps, want {n} a step")
    return apply_row, row


def phase_moe_conformance(kernel_fns):
    """fp32 (TF32 off), MoE flagship width, 2 layers, batch 2 x 1024: the
    loss and every gradient leaf through K6/K7 (``moe_gmm="auto"``)
    against the plain ragged engine (``moe_gmm=False``: one product per
    expert, plain autograd) on the card, loss within 1e-5 relative, each
    leaf within 1e-3 of its max |g|; the ``apply`` logits within 1e-3."""
    import torch
    from kubeflow_tpu_torch.compute import data
    from kubeflow_tpu_torch.compute.models import transformer
    batch = data.to_device(next(data.synthetic_lm(2, 1024, 32000, seed=8)),
                           "cuda")
    cfg = moe_config("float32", n_layers=2)
    plain = dataclasses.replace(cfg, moe_gmm=False)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     device="cuda")
    for fn in kernel_fns.values():
        fn.launches = 0
    gmm_loss, gmm_g = _grads(params, cfg, batch)
    torch.cuda.synchronize()
    launches = {n: kernel_fns[n].launches for n in ("grouped_matmul",
                                                    "grouped_matmul_dw")}
    plain_loss, plain_g = _grads(params, plain, batch)
    errs = _leaf_errors(gmm_g, plain_g)
    loss_rel = abs(gmm_loss - plain_loss) / abs(plain_loss)
    with torch.no_grad():
        a = transformer.apply(params, batch["tokens"], cfg)
        b = transformer.apply(params, batch["tokens"], plain)
        logits_err = float((a - b).abs().max())
    del a, b
    report = {"phase": "moe_conformance", "dtype": "float32", "layers": 2,
              "batch": [2, 1024], "loss": [gmm_loss, plain_loss],
              "loss_rel": loss_rel, "tol_loss": 1e-5,
              "leaf_rel_max": max(errs), "tol_leaf": 1e-3,
              "apply_logits_max_abs": logits_err, "tol_logits": 1e-3,
              "launches_kernel_engine": launches}
    emit(report)
    if loss_rel > 1e-5 or max(errs) > 1e-3 or logits_err > 1e-3:
        raise AssertionError(f"the grouped-matmul engine leaves the plain "
                             f"ragged engine: loss {loss_rel}, leaves "
                             f"{errs}, logits {logits_err}")
    if launches != {"grouped_matmul": 8, "grouped_matmul_dw": 4}:
        raise AssertionError(f"K6/K7 launches {launches} for 2 layers, "
                             f"want 8 and 4")
    return report


RESNET_BATCH, RESNET_IMAGE = 256, 224
# K8 against the unfused block, of the block output's max |value|: fp32
# differs by summation order only; in bf16 the roundings differ (weights
# folded with BN and rounded once, against a bf16 multiply-add after each
# conv) — 1.3e-2 measured on an H100, held to 3e-2
EVAL_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# the K8 forward's logits against the unfused forward's, of their max
# |value| (5.7e-3 measured on an H100)
EVAL_LOGITS_TOL = 5e-2


def resnet_weights(cfg, seed, device="cuda"):
    """ResNet weights from a seed with every BN quantity randomised →
    ``(params, stats)`` on ``device``."""
    import torch
    from kubeflow_tpu_torch.compute.models import resnet
    g = torch.Generator().manual_seed(seed)
    params, stats = resnet.init_params(cfg, g, device=device)

    def visit(p, st):
        for key in list(p):
            if isinstance(p[key], dict) and "scale" in p[key]:
                p[key], st[key] = random_bn(p[key]["scale"].shape[0], g,
                                            device)
            elif isinstance(p[key], dict):
                visit(p[key], st.get(key, {}))
            elif isinstance(p[key], list):
                for sub_p, sub_s in zip(p[key], st[key]):
                    for bp, bs in zip(sub_p, sub_s):
                        visit(bp, bs)

    visit(params, stats)
    return params, stats


def eval_forward(params, stats, x, cfg, fused, compare=None):
    """``resnet.apply(train=False)`` walked block by block → logits. With
    ``fused`` every identity block goes through K8
    (``fused_bottleneck_eval``), the others through ``resnet._block``.
    With ``compare`` (a list) every identity block's input goes through
    BOTH and the list takes max |Δ| over the unfused output's max
    |value|; the walk goes on from the unfused output."""
    from kubeflow_tpu_torch.compute.models import resnet
    from kubeflow_tpu_torch.compute.ops import fused_block
    h, _ = resnet._trunk_in(params, stats, x, cfg, False)
    for stage, blocks in enumerate(params["stages"]):
        for b, bp in enumerate(blocks):
            bs = stats["stages"][stage][b]
            identity = "proj" not in bp
            if identity and fused:
                h = fused_block.fused_bottleneck_eval(h, bp, bs, cfg.bn_eps)
                continue
            out, _ = resnet._block(h, bp, bs, cfg,
                                   resnet.block_stride(stage, b), False)
            if identity and compare is not None:
                k8 = fused_block.fused_bottleneck_eval(h, bp, bs, cfg.bn_eps)
                compare.append(
                    float((k8.float() - out.float()).abs().max())
                    / float(out.float().abs().max()))
            h = out
    return resnet._head(params, h)


def phase_resnet_eval(kernel_fns):
    """The ResNet-50 eval path: bf16, batch 256 at 224 px, random
    weights and randomised BN from a seed. First every identity block's
    input through both ``resnet._block`` and K8 (bf16 at batch 256, fp32
    at batch 8); then, counts zeroed just before and read just after,
    one forward with the 12 identity blocks through K8; then samples/s
    of the unfused forward (``resnet.apply``) and of the K8 forward."""
    import torch
    from kubeflow_tpu_torch.compute import data, train
    from kubeflow_tpu_torch.compute.models import resnet
    cfg = resnet.Config(depth=50, n_classes=1000, dtype="bfloat16")
    params, stats = resnet_weights(cfg, seed=10)
    before = [t.clone() for t in train.tree_leaves(stats)]
    batch = data.to_device(next(data.synthetic_images(
        RESNET_BATCH, RESNET_IMAGE, cfg.n_classes, seed=11)), "cuda")
    x = batch["image"]
    agreement = {}
    with torch.no_grad():
        for dtype_name, images in (("bfloat16", x), ("float32", x[:8])):
            errs = []
            eval_forward(params, stats, images,
                         dataclasses.replace(cfg, dtype=dtype_name), False,
                         compare=errs)
            agreement[dtype_name] = {"blocks": len(errs), "max_rel": max(errs),
                                     "tol": EVAL_TOL[dtype_name],
                                     "per_block": errs}
        plain_logits, new_stats = resnet.apply(params, stats, x, cfg,
                                               train=False)
        torch.cuda.synchronize()
        for fn in kernel_fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits = eval_forward(params, stats, x, cfg, True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernel_fns.items()}

        def timed(fn, runs=3):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / runs

        plain_s = timed(lambda: resnet.apply(params, stats, x, cfg,
                                             train=False))
        fused_s = timed(lambda: eval_forward(params, stats, x, cfg, True))
    logits_rel = float((logits - plain_logits).abs().max()) \
        / float(plain_logits.abs().max())
    untouched = all(torch.equal(a, b) for a, b in
                    zip(before, train.tree_leaves(new_stats)))
    row = {"phase": "resnet_eval", "dtype": "bfloat16",
           "batch": RESNET_BATCH, "image": RESNET_IMAGE, "depth": cfg.depth,
           "k8_vs_unfused_block": agreement,
           "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_vs_unfused_max_rel": logits_rel,
           "tol_logits": EVAL_LOGITS_TOL,
           "stats_untouched": untouched,
           "first_fused_forward_s": first_s,
           "unfused_forward_ms": 1e3 * plain_s,
           "unfused_samples_per_s": RESNET_BATCH / plain_s,
           "k8_forward_ms": 1e3 * fused_s,
           "k8_samples_per_s": RESNET_BATCH / fused_s,
           "launches": launches}
    emit(row)
    for dtype_name, a in agreement.items():
        if a["blocks"] != 12 or not a["max_rel"] <= a["tol"]:
            raise AssertionError(f"K8 leaves resnet._block in {dtype_name}: "
                                 f"{a}")
    if launches["fused_block"] != 12:
        raise AssertionError(f"the eval forward launched K8 "
                             f"{launches['fused_block']} times, want 12")
    if not row["finite"] or tuple(logits.shape) != (RESNET_BATCH,
                                                    cfg.n_classes):
        raise AssertionError("ResNet eval gave non-finite or misshapen "
                             "logits")
    if not untouched:
        raise AssertionError("eval mode changed the batch statistics")
    if not logits_rel <= EVAL_LOGITS_TOL:
        raise AssertionError(f"the K8 forward's logits leave the unfused "
                             f"forward's by {logits_rel} of their max")
    return row


RESNET_WARM, RESNET_TIMED = 2, 3


def phase_resnet_train(kernel_fns):
    """The ResNet-50 train path: bf16, ``init_state(extra=stats)`` →
    ``make_train_step(stateful_loss(resnet.loss_fn))`` → ``fit`` over one
    repeated 256 x 224 x 224 x 3 ``synthetic_images`` batch, 2 warm + 3
    timed steps (lr 1e-3, warmup 1), then one step profiled. The
    convolutions are cuDNN's (XLA's in JAX): no hand-written kernel is
    on this path."""
    import torch
    from kubeflow_tpu_torch.compute import data, profiler, telemetry, train
    from kubeflow_tpu_torch.compute.models import resnet
    cfg = resnet.Config(depth=50, n_classes=1000, dtype="bfloat16")
    params, stats = resnet.init_params(
        cfg, torch.Generator().manual_seed(0), device="cuda")
    opt = train.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                               total_steps=100)
    state = train.init_state(lambda g, device: params, opt, device="cuda",
                             extra=stats)
    mean_before = state.extra["stages"][3][2]["bn2"]["mean"].clone()
    step = train.make_train_step(train.stateful_loss(resnet.loss_fn, cfg),
                                 opt)

    def synced(state, batch):
        out = step(state, batch)
        torch.cuda.synchronize()
        return out

    batch = next(data.synthetic_images(RESNET_BATCH, RESNET_IMAGE,
                                       cfg.n_classes, seed=12))
    flops_per_step = resnet.flops_per_sample(cfg.depth) * RESNET_BATCH
    peak = telemetry.peak_flops()
    tel = telemetry.TrainTelemetry("resnet50-train",
                                   flops_per_step=flops_per_step, peak=peak)
    n_steps = RESNET_WARM + RESNET_TIMED
    marks, losses = [], []

    def on_step(n, metrics):
        marks.append(time.perf_counter())
        losses.append(metrics["loss"])

    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = train.fit(state, synced, itertools.repeat(batch, n_steps),
                               on_step=on_step, telemetry=tel)
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = [b - a for a, b in zip(marks[RESNET_WARM - 1:],
                                    marks[RESNET_WARM:])]
    step_ms = 1e3 * statistics.mean(step_s)
    with profiler.trace("build/profile") as cap:
        w0 = time.perf_counter()
        state, _ = synced(state, data.to_device(batch, "cuda"))
        wall_ms = 1e3 * (time.perf_counter() - w0)
    prof = profiler.device_summary(cap.profile, wall_ms)
    moved = float((state.extra["stages"][3][2]["bn2"]["mean"]
                   - mean_before).abs().max())
    row = {"phase": "resnet_train", "dtype": "bfloat16",
           "batch": RESNET_BATCH, "image": RESNET_IMAGE, "depth": cfg.depth,
           "steps": n_steps, "timed_steps": RESNET_TIMED,
           "first_step_s": marks[0] - t0, "step_ms": step_ms,
           "step_ms_each": [1e3 * x for x in step_s],
           "samples_per_s": RESNET_BATCH / (step_ms / 1e3),
           "flops_per_sample": resnet.flops_per_sample(cfg.depth),
           "peak_flops": peak,
           "mfu": flops_per_step / (step_ms / 1e3) / peak,
           "telemetry_mfu": tel.live_mfu(),
           "peak_memory_bytes": peak_mem, "losses": losses,
           "accuracy": float(metrics["accuracy"]),
           "grad_norm": float(metrics["grad_norm"]),
           "running_mean_moved_max": moved, "launches": launches}
    emit(row)
    emit({"phase": "resnet_train_profile", "trace": cap.path, **prof})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet train loss did not fall: {losses}")
    if not moved > 0:
        raise AssertionError("the running means did not move")
    return row


BERT_BATCH = 16
BERT_WARM, BERT_TIMED = 2, 3
BERT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def phase_bert_train(kernel_fns):
    """The BERT path: bert-base (12 layers, d_model 768, 12 heads of 64,
    ff 3072, S 512, bf16, ``remat=False``, per-layer weights) trained on
    one repeated 16 x 512 ``mlm_batch``, 2 warm + 3 timed steps (lr
    1e-4, warmup 1); every step launches K3, K4 and K5 12 times each.
    Then one step profiled."""
    import torch
    from kubeflow_tpu_torch.compute import data, profiler, telemetry, train
    from kubeflow_tpu_torch.compute.models import bert
    cfg = bert.Config(remat=False, scan_layers=False)
    opt = train.make_optimizer(learning_rate=1e-4, warmup_steps=1,
                               total_steps=100)
    state = train.init_state(functools.partial(bert.init_params, cfg), opt,
                             device="cuda",
                             generator=torch.Generator().manual_seed(0))
    step = train.make_train_step(train.plain_loss(bert.loss_fn, cfg), opt)

    def synced(state, batch):
        out = step(state, batch)
        torch.cuda.synchronize()
        return out

    batch = bert.mlm_batch(np.random.default_rng(13), BERT_BATCH, cfg)
    tokens = BERT_BATCH * cfg.max_seq
    flops_per_step = bert.flops_per_token(cfg) * tokens
    peak = telemetry.peak_flops()
    tel = telemetry.TrainTelemetry("bert-base-train",
                                   flops_per_step=flops_per_step, peak=peak)
    n_steps = BERT_WARM + BERT_TIMED
    marks, losses = [], []

    def on_step(n, metrics):
        marks.append(time.perf_counter())
        losses.append(metrics["loss"])

    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = train.fit(state, synced, itertools.repeat(batch, n_steps),
                               on_step=on_step, telemetry=tel)
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = [b - a for a, b in zip(marks[BERT_WARM - 1:], marks[BERT_WARM:])]
    step_ms = 1e3 * statistics.mean(step_s)
    with profiler.trace("build/profile") as cap:
        w0 = time.perf_counter()
        state, _ = synced(state, data.to_device(batch, "cuda"))
        wall_ms = 1e3 * (time.perf_counter() - w0)
    prof = profiler.device_summary(cap.profile, wall_ms)
    row = {"phase": "bert_train", "dtype": "bfloat16", "batch": BERT_BATCH,
           "seq": cfg.max_seq, "layers": cfg.n_layers,
           "params": bert.param_count(cfg), "steps": n_steps,
           "timed_steps": BERT_TIMED, "first_step_s": marks[0] - t0,
           "step_ms": step_ms, "step_ms_each": [1e3 * x for x in step_s],
           "tokens_per_s": tokens / (step_ms / 1e3),
           "flops_per_token": bert.flops_per_token(cfg), "peak_flops": peak,
           "mfu": flops_per_step / (step_ms / 1e3) / peak,
           "telemetry_mfu": tel.live_mfu(),
           "peak_memory_bytes": peak_mem, "losses": losses,
           "mlm_accuracy": float(metrics["mlm_accuracy"]),
           "grad_norm": float(metrics["grad_norm"]), "launches": launches,
           "launches_per_step": {k: v / n_steps for k, v in launches.items()}}
    emit(row)
    emit({"phase": "bert_train_profile", "trace": cap.path, **prof})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"BERT train loss did not fall: {losses}")
    for name in BERT_KERNELS:
        if launches[name] != cfg.n_layers * n_steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {n_steps} BERT "
                f"steps, want {cfg.n_layers} a step")
    return row


def phase_bert_conformance(kernel_fns):
    """fp32 (TF32 off), bert-base width, 2 layers, batch 2 x 512: the loss
    and every gradient leaf through K3/K4/K5 (no causal mask, head_dim
    64) against ``attention="dense"`` (plain PyTorch autograd) on the
    card, loss within 1e-5 relative, each leaf within 1e-3 of its max
    |g| (a leaf whose gradient is zero analytically, the key bias, within
    1e-7 absolute)."""
    import torch
    from kubeflow_tpu_torch.compute import data, train
    from kubeflow_tpu_torch.compute.models import bert
    cfg = bert.Config(n_layers=2, dtype="float32", remat=False,
                      scan_layers=False)
    params = bert.init_params(cfg, torch.Generator().manual_seed(4),
                              device="cuda")
    batch = data.to_device(
        bert.mlm_batch(np.random.default_rng(14), 2, cfg), "cuda")

    def grads(config):
        tree = train.tree_map(lambda t: t.detach().clone().requires_grad_(),
                              params)
        leaves = train.tree_leaves(tree)
        loss, _ = bert.loss_fn(tree, batch, config)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, got)]

    for fn in kernel_fns.values():
        fn.launches = 0
    flash_loss, flash_g = grads(cfg)
    torch.cuda.synchronize()
    launches = {n: kernel_fns[n].launches for n in BERT_KERNELS}
    dense_loss, dense_g = grads(dataclasses.replace(cfg, attention="dense"))
    loss_rel = abs(flash_loss - dense_loss) / abs(dense_loss)
    worst = 0.0
    for a, b in zip(flash_g, dense_g):
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        if diff > 1e-7:
            worst = max(worst, diff / max(scale, 1e-30))
    report = {"phase": "bert_conformance", "dtype": "float32", "layers": 2,
              "batch": [2, cfg.max_seq], "head_dim": cfg.head_dim,
              "causal": False, "loss": [flash_loss, dense_loss],
              "loss_rel": loss_rel, "tol_loss": 1e-5,
              "leaf_rel_max": worst, "tol_leaf": 1e-3,
              "launches": launches}
    emit(report)
    if loss_rel > 1e-5 or worst > 1e-3:
        raise AssertionError(f"BERT's flash gradients leave the dense ones: "
                             f"loss {loss_rel}, leaves {worst}")
    if launches != {n: 2 for n in BERT_KERNELS}:
        raise AssertionError(f"K3/K4/K5 launches {launches} for 2 layers, "
                             f"want 2 each")
    return report


# ------------------------------------------------------ the training mesh

MESH_STEPS = 3
CARD = "cuda:0"          # every position of the mesh phases' meshes


def check_mesh_launches(launches, names, per_step, steps, path):
    """Each of ``names`` launched exactly ``per_step`` times a step (one
    a layer per mesh position: every position holds a batch piece)."""
    bad = {n: launches[n] for n in names if launches[n] != per_step * steps}
    if bad:
        raise AssertionError(f"{path}: launches {bad} in {steps} steps, "
                             f"want {per_step} a step each")


def unequal_copies(state):
    """``(leaf, position)`` of every replicated copy of a mesh state's
    params, moments or model state that differs from its group's first
    copy by a single bit."""
    import torch
    from kubeflow_tpu_torch.compute import train
    leaves = [x for tree in (state.params, state.opt_state["mu"],
                             state.opt_state["nu"], state.extra)
              for x in train.tree_leaves(tree)]
    return [(i, q) for i, leaf in enumerate(leaves)
            for group in leaf.sharding.copies for q in group[1:]
            if not torch.equal(leaf.pieces[q], leaf.pieces[group[0]])]


def params_rule(got, want, lr, updates, whole_model=False):
    """``tests/test_torch_train.py``'s rule for params after ``updates``
    nonzero-rate updates → ``(worst |Δ|, worst share of a leaf beyond
    1e-6, ok)``; it holds when the first is at most 2·lr·updates and the
    second at most 0.1 %. ``whole_model`` takes the share over all
    elements at once, as ``tests/test_torch_train_mesh.py`` does for
    ResNet, whose BN leaves of 64 channels hold one element in 1.6 %."""
    worst, beyond, total, share = 0.0, 0, 0, 0.0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        worst = max(worst, float(d.max()))
        n = int((d > 1e-6).sum())
        beyond, total = beyond + n, total + d.numel()
        share = max(share, n / d.numel())
    if whole_model:
        share = beyond / total
    ok = worst <= 2 * lr * updates and share <= 1e-3
    return worst, share, ok


def mesh_grads(state, loss_fn, batch):
    """A mesh state's ``(loss, each leaf's logical gradient)``: every
    position's gradient summed over its piece's copies (the train
    step's sum), the pieces gathered."""
    import torch
    from kubeflow_tpu_torch.compute import sharding, train
    leaves = train.tree_leaves(state.params)
    pieces = sharding.pieces_of(leaves)
    loss, _ = loss_fn(state.params, state.extra, batch)
    raw = torch.autograd.grad(loss, pieces, allow_unused=True)
    raw = [torch.zeros_like(p) if g is None else g
           for p, g in zip(pieces, raw)]
    summed, _ = train._sum_copies(leaves, raw)
    out, start = [], 0
    for leaf in leaves:
        n = len(leaf.pieces)
        out.append(sharding.Sharded(summed[start:start + n], leaf.sharding,
                                    leaf.shape).gather())
        start += n
    return float(loss.detach()), out


def _mesh_training(name, init_fn, logical_axes, loss, mesh, batch,
                   flops_per_step, kernel_fns, lr, extra=None,
                   steps=MESH_STEPS):
    """``init_state(mesh=)`` → ``make_train_step(mesh=)`` → ``fit(mesh=)``
    over ``steps`` repeats of ``batch`` (warmup 1), each step waiting
    for the card; counts zeroed just before ``fit`` and read just after.
    → ``(state, row)``: step ms of the steps after the first, peak
    memory, the telemetry's live MFU over the mesh's distinct card, the
    copies that differ, and whether every gathered param is finite."""
    import torch
    from kubeflow_tpu_torch.compute import telemetry, train
    t_phase = time.perf_counter()
    opt = train.make_optimizer(learning_rate=lr, warmup_steps=1,
                               total_steps=100)
    state = train.init_state(init_fn, opt, mesh=mesh,
                             logical_axes=logical_axes,
                             generator=torch.Generator().manual_seed(0),
                             extra=extra)
    step = train.make_train_step(loss, opt, mesh=mesh)

    def synced(state, batch):
        out = step(state, batch)
        torch.cuda.synchronize()
        return out

    tel = telemetry.TrainTelemetry(name, flops_per_step=flops_per_step,
                                   peak=telemetry.mesh_peak_flops(mesh))
    marks, losses, auxs = [], [], []

    def on_step(n, metrics):
        marks.append(time.perf_counter())
        losses.append(metrics["loss"])
        auxs.append(metrics.get("moe_aux"))

    _zero(kernel_fns)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = train.fit(state, synced, itertools.repeat(batch, steps),
                               mesh, on_step=on_step, telemetry=tel)
    launches = _launches(kernel_fns)
    peak_mem = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    finite = all(bool(torch.isfinite(leaf.gather(mesh.devices[0])).all())
                 for leaf in train.tree_leaves(state.params))
    row = {"phase": name,
           "mesh": {a: n for a, n in mesh.shape.items() if n > 1},
           "positions": mesh.size,
           "devices": [str(d) for d in dict.fromkeys(mesh.devices)],
           "steps": steps, "first_step_s": marks[0] - t0,
           "step_ms": 1e3 * statistics.mean(step_s),
           "step_ms_each": [1e3 * x for x in step_s],
           "peak_memory_bytes": peak_mem,
           "losses": [float(x) for x in losses],
           "grad_norm": float(metrics["grad_norm"]),
           "flops_per_step": flops_per_step,
           "peak_flops": telemetry.mesh_peak_flops(mesh),
           "live_mfu": tel.live_mfu(),
           "copies_unequal": unequal_copies(state)[:8],
           "params_finite": finite, "launches": launches,
           "launches_per_step": {k: v / steps
                                 for k, v in launches.items()}}
    if auxs[0] is not None:
        row["moe_aux"] = [float(x) for x in auxs]
    row["seconds"] = time.perf_counter() - t_phase
    if row["copies_unequal"]:
        raise AssertionError(f"{name}: replicated copies differ: "
                             f"{row['copies_unequal']}")
    if not finite or not all(np.isfinite(row["losses"])):
        raise AssertionError(f"{name}: non-finite params or losses: "
                             f"{row['losses']}")
    return state, row


def phase_train_mesh(kernel_fns, train_row):
    """The flagship (bf16, ``remat=False``) trained on ``data=2,
    tensor=2`` over four positions of the one card: each tensor shard
    holds 4 q heads and 1 KV head. 3 steps on one 16 x 1024 batch: the
    loss falls, K3/K4/K5 launch 12 x 4 = 48 times a step each, the
    copies stay byte-equal, the params finite; step ms beside the
    ``train`` phase's (one card: not a speed result)."""
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = flagship_config(remat=False)
    mesh = mesh_lib.make_mesh(data=2, tensor=2, devices=[CARD] * 4)
    B, S = TRAIN_BATCH
    batch = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=4))
    _, row = _mesh_training(
        "train_mesh", functools.partial(transformer.init_params, cfg),
        transformer.logical_axes(cfg),
        train.plain_loss(transformer.loss_fn, cfg), mesh, batch,
        transformer.flops_per_token(cfg) * B * S, kernel_fns, lr=1e-3)
    row.update(dtype="bfloat16", batch=B, seq=S, layers=cfg.n_layers,
               heads_per_shard=cfg.n_heads // 2,
               kv_heads_per_shard=cfg.kv_heads // 2,
               train_step_ms=train_row["step_ms"],
               train_peak_memory_bytes=train_row["peak_memory_bytes"])
    emit(row)
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"train_mesh loss did not fall: "
                             f"{row['losses']}")
    check_mesh_launches(row["launches"], BERT_KERNELS,
                        cfg.n_layers * mesh.size, MESH_STEPS, "train_mesh")
    return row


def phase_train_mesh_conformance(kernel_fns):
    """fp32 (TF32 off), flagship width, 2 layers, batch 4 x 1024: the
    mesh ``data=2, fsdp=2, tensor=2`` over eight positions of the card
    against the port's unsharded step on the same weights (see
    :func:`mesh_conformance`)."""
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    cfg = flagship_config("float32", n_layers=2, remat=False)
    mesh = mesh_lib.make_mesh(data=2, fsdp=2, tensor=2, devices=[CARD] * 8)
    return mesh_conformance("train_mesh_conformance", cfg, cfg, mesh,
                            kernel_fns, cfg.n_layers * mesh.size)


class RouterTape:
    """Each MoE layer's top-k choices over one forward, in global row
    order: ``transformer._router``'s calls are taken in call order, call
    ``i`` routing layer ``i mod n_layers`` (one device, a mesh's pieces in
    turn, GPipe's microbatches: each walks the layers in order and the
    rows in order). With ``replay`` (another tape) every call keeps its
    own probabilities but takes the recorded choices, its gates
    renormalised over them. Top-k routing is discontinuous: a token
    whose k-th and (k+1)-th probabilities lie within fp32 rounding of
    each other may choose differently under another summation order
    (one token of 4096 in each fp32 MoE conformance case on an H100,
    2.1e-7 and 4.0e-7 apart), so a gradient comparison between two
    routes of the same model needs the same choices on both. Needs
    ``remat=False`` (a recomputed forward would route again)."""

    def __init__(self, config, replay=None):
        self.n_layers, self.replay = config.n_layers, replay
        self.calls = [[] for _ in range(config.n_layers)]
        self._count = 0

    def __enter__(self):
        from kubeflow_tpu_torch.compute.models import transformer
        self._plain = plain = transformer._router

        def routed(h, lp, config):
            import torch
            probs, gate_vals, idx = plain(h, lp, config)
            layer = self._count % self.n_layers
            self._count += 1
            if self.replay is not None:
                start = sum(i.shape[0] for i, _ in self.calls[layer])
                idx = self.replay.choices(layer)[start:start + h.shape[0]].to(
                    idx.device)
                gate_vals = torch.gather(probs, -1, idx)
                gate_vals = gate_vals / gate_vals.sum(
                    -1, keepdim=True).clamp_min(1e-9)
            self.calls[layer].append((idx.detach(), probs.detach()))
            return probs, gate_vals, idx

        transformer._router = routed
        return self

    def __exit__(self, *exc):
        from kubeflow_tpu_torch.compute.models import transformer
        transformer._router = self._plain

    def choices(self, layer):
        import torch
        return torch.cat([i.to(self.calls[layer][0][0].device)
                          for i, _ in self.calls[layer]])

    def flips(self, other):
        """Tokens whose set of k choices differs from ``other``'s, and
        the smallest gap between the k-th and (k+1)-th probability at
        them (on ``other``'s side)."""
        import torch
        n, gaps = 0, []
        for layer in range(self.n_layers):
            a = torch.sort(self.choices(layer), -1).values
            b = torch.sort(other.choices(layer), -1).values.to(a.device)
            differ = (a != b).any(-1)
            n += int(differ.sum())
            probs = torch.cat([p.to(a.device) for _, p in
                               other.calls[layer]])
            top = torch.sort(probs, -1, descending=True).values
            k = a.shape[-1]
            if differ.any() and k < top.shape[-1]:
                gaps.append(float((top[..., k - 1] - top[..., k])[
                    differ].min()))
        return n, (min(gaps) if gaps else None)


class _NoTape:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _tape(cfg, replay=None):
    return RouterTape(cfg, replay) if cfg.moe_experts else _NoTape()


def mesh_conformance(name, cfg, plain_cfg, mesh, kernel_fns, per_call,
                     rows=4, seed=21, tol_loss=1e-5, tol_leaf=1e-3):
    """The transformer ``cfg`` on ``mesh`` against the port's unsharded
    step under ``plain_cfg`` on the same fp32 weights and a ``rows`` x
    1024 batch: loss within ``tol_loss`` relative, each leaf's gradient
    within ``tol_leaf`` of its max |g|, the params after one update
    (rate lr: warmup 0) by ``tests/test_torch_train.py``'s rule, the
    copies byte-equal; K3–K5 launch ``per_call`` times each in the
    mesh's gradient. An MoE's unsharded side replays the mesh's top-k
    choices (:class:`RouterTape`); the tokens a free one-device run
    routes otherwise are reported with their top-k gaps."""
    import torch
    from kubeflow_tpu_torch.compute import data, train
    from kubeflow_tpu_torch.compute.models import transformer
    t_phase = time.perf_counter()
    host = next(data.synthetic_lm(rows, 1024, cfg.vocab_size, seed=seed))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1),
                                     device="cpu")
    loss = train.plain_loss(transformer.loss_fn, cfg)
    plain_loss = train.plain_loss(transformer.loss_fn, plain_cfg)
    lr = 1e-3

    def fresh(**where):
        opt = train.make_optimizer(learning_rate=lr, warmup_steps=0,
                                   total_steps=100)
        return opt, train.init_state(
            lambda g, device: train.tree_map(torch.clone, params), opt,
            **where)

    m_opt, ms = fresh(mesh=mesh, logical_axes=transformer.logical_axes(
        dataclasses.replace(cfg, scan_layers=True)))
    card = mesh.devices[0]
    u_opt, us = fresh(device=card)
    placed = data.shard_batch(host, mesh)
    batch = data.to_device(host, card)
    _zero(kernel_fns)
    with _tape(cfg) as m_tape:
        m_loss, m_g = mesh_grads(ms, loss, placed)
    torch.cuda.synchronize()
    launches = {n: kernel_fns[n].launches for n in BERT_KERNELS
                + (MOE_KERNELS[:2] if cfg.moe_experts else ())}
    routing = None
    if cfg.moe_experts:       # a free one-device forward: its own choices
        with _tape(cfg) as free:
            with torch.no_grad():
                plain_loss(us.params, us.extra, batch)
        flipped, gap = m_tape.flips(free)
        routing = {"free_run_tokens_routed_otherwise": flipped,
                   "their_min_top_k_gap": gap, "replayed": True}
    u_leaves = train.tree_leaves(us.params)
    with _tape(cfg, replay=m_tape if cfg.moe_experts else None):
        u_value, _ = plain_loss(us.params, us.extra, batch)
    u_g = torch.autograd.grad(u_value, u_leaves)
    u_loss = float(u_value.detach())
    errs = _leaf_errors(m_g, u_g)
    loss_rel = abs(m_loss - u_loss) / abs(u_loss)
    with _tape(cfg) as m_tape:
        ms, mm = train.make_train_step(loss, m_opt, mesh=mesh)(ms, placed)
    with _tape(cfg, replay=m_tape if cfg.moe_experts else None):
        us, um = train.make_train_step(plain_loss, u_opt)(us, batch)
    worst, share, ok = params_rule(
        train.tree_leaves(train.gather_params(ms, card)),
        [t.detach() for t in train.tree_leaves(us.params)], lr, 1)
    report = {"phase": name, "dtype": "float32",
              "layers": cfg.n_layers, "batch": [rows, 1024],
              "attention": [cfg.attention, plain_cfg.attention],
              "pipeline_stages": cfg.pipeline_stages,
              "microbatches": cfg.microbatches,
              "mesh": {a: n for a, n in mesh.shape.items() if n > 1},
              "loss": [m_loss, u_loss], "loss_rel": loss_rel,
              "tol_loss": tol_loss, "leaf_rel_max": max(errs),
              "tol_leaf": tol_leaf,
              "grad_norm": [float(mm["grad_norm"]), float(um["grad_norm"])],
              "params_max_abs": worst, "params_share_over_1e-6": share,
              "params_rule": {"max_abs": 2 * lr, "share": 1e-3},
              "copies_unequal": unequal_copies(ms)[:8],
              "launches": launches,
              "seconds": time.perf_counter() - t_phase}
    if cfg.moe_experts:
        report.update(moe_dropless=cfg.moe_dropless, moe_top_k=cfg.moe_top_k,
                      moe_aux=[float(mm["moe_aux"]), float(um["moe_aux"])],
                      routing=routing)
    emit(report)
    if loss_rel > tol_loss or max(errs) > tol_leaf:
        raise AssertionError(f"{name}: the mesh leaves the unsharded step: "
                             f"loss {loss_rel}, leaves {errs}")
    if not ok or report["copies_unequal"]:
        raise AssertionError(f"{name}: params after one update: {worst}, "
                             f"{share}; copies {report['copies_unequal']}")
    check_mesh_launches(launches, BERT_KERNELS, per_call, 1, name)
    return report


def phase_bert_mesh(kernel_fns, bert_row):
    """bert-base (bf16, ``remat=False``, per-layer weights) on ``data=2,
    fsdp=2, tensor=2`` over eight positions of the card, 3 steps on one
    16 x 512 ``mlm_batch``: the loss falls, K3–K5 launch 12 x 8 = 96 times
    a step each. Then fp32 at 2 layers on 8 rows whose pieces hold
    different masked-token counts: the mesh loss equals the unsharded
    loss within 1e-5 relative."""
    import torch
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib, train
    from kubeflow_tpu_torch.compute.models import bert
    cfg = bert.Config(remat=False, scan_layers=False)
    mesh = mesh_lib.make_mesh(data=2, fsdp=2, tensor=2, devices=[CARD] * 8)
    batch = bert.mlm_batch(np.random.default_rng(13), BERT_BATCH, cfg)
    tokens = BERT_BATCH * cfg.max_seq
    state, row = _mesh_training(
        "bert_mesh", functools.partial(bert.init_params, cfg),
        bert.logical_axes(cfg), train.plain_loss(bert.loss_fn, cfg), mesh,
        batch, bert.flops_per_token(cfg) * tokens, kernel_fns, lr=1e-4)
    del state
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    host = bert.mlm_batch(np.random.default_rng(14), 8, cfg2)
    counts = host["mask"].reshape(4, -1).sum(1).tolist()
    params = bert.init_params(cfg2, torch.Generator().manual_seed(4),
                              device="cpu")
    with torch.no_grad():
        placed = train.init_state(
            lambda g, device: params, train.make_optimizer(), mesh=mesh,
            logical_axes=bert.logical_axes(cfg2))
        m_loss = float(bert.loss_fn(placed.params,
                                    data.shard_batch(host, mesh), cfg2)[0])
        card = mesh.devices[0]
        u_loss = float(bert.loss_fn(
            train.tree_map(lambda t: t.to(card), params),
            data.to_device(host, card), cfg2)[0])
    rel = abs(m_loss - u_loss) / abs(u_loss)
    row.update(dtype="bfloat16", batch=BERT_BATCH, seq=cfg.max_seq,
               layers=cfg.n_layers, bert_train_step_ms=bert_row["step_ms"],
               fp32_check={"layers": 2, "rows": 8, "piece_mask_counts": counts,
                           "loss": [m_loss, u_loss], "loss_rel": rel,
                           "tol": 1e-5,
                           "seconds": time.perf_counter() - t_check})
    emit(row)
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"bert_mesh loss did not fall: {row['losses']}")
    check_mesh_launches(row["launches"], BERT_KERNELS,
                        cfg.n_layers * mesh.size, MESH_STEPS, "bert_mesh")
    if len(set(counts)) < 2 or rel > 1e-5:
        raise AssertionError(f"bert_mesh fp32: counts {counts}, loss rel "
                             f"{rel}")
    return row


def phase_resnet_mesh(kernel_fns, resnet_row):
    """ResNet-50 (bf16) on ``data=2`` over two positions of the card, 2
    steps on one 256 x 224² batch (sync BN over the two pieces; the
    convolutions are cuDNN's, so no hand-written kernel launches). Then
    fp32 at depth 50 on 8 images, one step at rate lr (warmup 0) on each
    side. With every BN quantity randomised, the loss and every running
    statistic equal the unsharded step's within 1e-5 (relative; a
    statistic of its leaf's max |value|). At the seed's init, the
    gradient through the synchronized batch norm: the pre-clip norm
    within 1e-5 and the params after the update by
    ``tests/test_torch_train.py``'s rule over all elements."""
    import torch
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib
    from kubeflow_tpu_torch.compute import train
    from kubeflow_tpu_torch.compute.models import resnet
    cfg = resnet.Config(depth=50, n_classes=1000, dtype="bfloat16")
    mesh = mesh_lib.make_mesh(data=2, devices=[CARD] * 2)
    card = mesh.devices[0]
    params, stats = resnet.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    p_axes, _ = resnet.logical_axes(cfg)
    batch = next(data.synthetic_images(RESNET_BATCH, RESNET_IMAGE,
                                       cfg.n_classes, seed=12))
    state, row = _mesh_training(
        "resnet_mesh", lambda g, device: params, p_axes,
        train.stateful_loss(resnet.loss_fn, cfg), mesh, batch,
        resnet.flops_per_sample(cfg.depth) * RESNET_BATCH, kernel_fns,
        lr=1e-3, extra=stats, steps=2)
    before = stats["stages"][3][2]["bn2"]["mean"].to(card)
    moved = float((state.extra["stages"][3][2]["bn2"]["mean"].pieces[0]
                   - before).abs().max())
    del state
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    host = next(data.synthetic_images(8, RESNET_IMAGE, cfg.n_classes,
                                      seed=16))
    report = resnet_fp32_report(_resnet_fp32_sides(host, 1e-3, mesh),
                                _resnet_fp32_sides(host, 1e-3), 1e-3)
    row.update(dtype="bfloat16", batch=RESNET_BATCH, image=RESNET_IMAGE,
               depth=cfg.depth, running_mean_moved_max=moved,
               resnet_train_step_ms=resnet_row["step_ms"],
               fp32_check={**report,
                           "seconds": time.perf_counter() - t_check})
    emit(row)
    if not moved > 0:
        raise AssertionError("resnet_mesh: the running means did not move")
    check_resnet_fp32(report, "resnet_mesh fp32 sync BN")
    return row


# ------------------------------------------- the sequence and pipeline axes

RING_BATCH = (2, 4096)   # 4x the flagship's 1024 context
RING_SEQ = 4
PIPE_MICRO = 4
F1B_MICRO = 8
#: relative gap a bf16 loss may keep from another bf16 route's on the
#: same weights and batch (flash vs the fp32-folded ring, pipelined vs
#: whole-batch reductions)
BF16_LOSS_REL = 1e-2


def _train_steps(name, cfg, batch, steps=MESH_STEPS, lr=1e-3):
    """The unsharded baseline: ``steps`` one-device steps of ``cfg`` on
    ``batch`` (seed-0 weights, the mesh phases' init) → a row with the
    losses, step ms of the steps after the first and peak memory."""
    import torch
    from kubeflow_tpu_torch.compute import data, train
    from kubeflow_tpu_torch.compute.models import transformer
    opt = train.make_optimizer(learning_rate=lr, warmup_steps=1,
                               total_steps=100)
    state = train.init_state(functools.partial(transformer.init_params, cfg),
                             opt, device=CARD,
                             generator=torch.Generator().manual_seed(0))
    step = train.make_train_step(train.plain_loss(transformer.loss_fn, cfg),
                                 opt)
    batch = data.to_device(batch, CARD)
    torch.cuda.reset_peak_memory_stats()
    marks, losses = [time.perf_counter()], []
    for _ in range(steps):
        state, m = step(state, batch)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(m["loss"]))
    step_s = [b - a for a, b in zip(marks[1:], marks[2:])]
    del state
    return {"phase": name, "losses": losses,
            "step_ms": 1e3 * statistics.mean(step_s),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _rel(a, b):
    return abs(a - b) / abs(b)


def phase_ring_mesh(kernel_fns):
    """The flagship (bf16, ``remat=True``) with ``attention="ring"`` on
    ``sequence=4`` over four positions of the card, 3 steps on one 2 x
    4096 batch (4x its 1024 context): each position holds 1024 tokens
    and its own copy of the replicated params, the K/V blocks hop
    around the ring. The loss falls, K3–K5 never launch (the ring's fold
    is plain PyTorch), the copies stay byte-equal; step 1's loss is the
    unsharded one-device flash step's on the same weights and batch
    within ``BF16_LOSS_REL``. Step ms, tokens/s and peak memory beside
    that baseline's (one card: not a speed result)."""
    import torch
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib, train
    from kubeflow_tpu_torch.compute.models import transformer
    B, S = RING_BATCH
    cfg = flagship_config(attention="ring", remat=True, max_seq=S)
    mesh = mesh_lib.make_mesh(sequence=RING_SEQ, devices=[CARD] * RING_SEQ)
    batch = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=31))
    state, row = _mesh_training(
        "ring_mesh", functools.partial(transformer.init_params, cfg),
        transformer.logical_axes(cfg),
        train.plain_loss(transformer.loss_fn, cfg), mesh, batch,
        transformer.flops_per_token(cfg) * B * S, kernel_fns, lr=1e-3)
    del state
    torch.cuda.empty_cache()
    base = _train_steps("ring_baseline", dataclasses.replace(
        cfg, attention="flash"), batch)
    torch.cuda.empty_cache()
    row.update(dtype="bfloat16", batch=B, seq=S, layers=cfg.n_layers,
               remat=cfg.remat, tokens_per_position=S // RING_SEQ,
               tokens_per_s=B * S / (row["step_ms"] / 1e3),
               baseline=dict(base, tokens_per_s=B * S / (
                   base["step_ms"] / 1e3)),
               step1_loss_rel=_rel(row["losses"][0], base["losses"][0]),
               tol_step1_loss_rel=BF16_LOSS_REL)
    emit(row)
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"ring_mesh loss did not fall: {row['losses']}")
    check_mesh_launches(row["launches"], BERT_KERNELS, 0, MESH_STEPS,
                        "ring_mesh")
    if row["step1_loss_rel"] > BF16_LOSS_REL:
        raise AssertionError(f"ring_mesh step 1 loss {row['losses'][0]} vs "
                             f"flash {base['losses'][0]}")
    return row


def phase_ring_conformance(kernel_fns):
    """fp32, flagship width, 2 layers, 4 x 1024, ring attention on
    ``data=2, sequence=2, tensor=2`` against the unsharded dense step
    (:func:`mesh_conformance`); no K3–K5 launch."""
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    cfg = flagship_config("float32", attention="ring", n_layers=2,
                          remat=False)
    mesh = mesh_lib.make_mesh(data=2, sequence=2, tensor=2,
                              devices=[CARD] * 8)
    return mesh_conformance("ring_conformance", cfg,
                            dataclasses.replace(cfg, attention="dense"),
                            mesh, kernel_fns, 0, seed=22)


def phase_bert_ring(kernel_fns, bert_row):
    """bert-base (bf16, ``remat=False``, per-layer weights) with
    ``attention="ring"`` (non-causal) on ``sequence=2`` over two
    positions of the card, 3 steps on one 16 x 512 ``mlm_batch``: the
    loss falls, no K3–K5 launch. Then fp32 at 2 layers on 8 rows: the
    mesh's global-batch loss equals the unsharded dense loss within
    1e-5 relative."""
    import torch
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib, train
    from kubeflow_tpu_torch.compute.models import bert
    cfg = bert.Config(remat=False, scan_layers=False, attention="ring")
    mesh = mesh_lib.make_mesh(sequence=2, devices=[CARD] * 2)
    batch = bert.mlm_batch(np.random.default_rng(15), BERT_BATCH, cfg)
    tokens = BERT_BATCH * cfg.max_seq
    state, row = _mesh_training(
        "bert_ring", functools.partial(bert.init_params, cfg),
        bert.logical_axes(cfg), train.plain_loss(bert.loss_fn, cfg), mesh,
        batch, bert.flops_per_token(cfg) * tokens, kernel_fns, lr=1e-4)
    del state
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    host = bert.mlm_batch(np.random.default_rng(16), 8, cfg2)
    params = bert.init_params(cfg2, torch.Generator().manual_seed(4),
                              device="cpu")
    with torch.no_grad():
        placed = train.init_state(
            lambda g, device: params, train.make_optimizer(), mesh=mesh,
            logical_axes=bert.logical_axes(cfg2))
        m_loss = float(bert.loss_fn(placed.params,
                                    data.shard_batch(host, mesh), cfg2)[0])
        u_loss = float(bert.loss_fn(
            train.tree_map(lambda t: t.to(CARD), params),
            data.to_device(host, CARD),
            dataclasses.replace(cfg2, attention="dense"))[0])
    rel = _rel(m_loss, u_loss)
    row.update(dtype="bfloat16", batch=BERT_BATCH, seq=cfg.max_seq,
               layers=cfg.n_layers, bert_train_step_ms=bert_row["step_ms"],
               fp32_check={"layers": 2, "rows": 8, "loss": [m_loss, u_loss],
                           "loss_rel": rel, "tol": 1e-5,
                           "seconds": time.perf_counter() - t_check})
    emit(row)
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"bert_ring loss did not fall: {row['losses']}")
    check_mesh_launches(row["launches"], BERT_KERNELS, 0, MESH_STEPS,
                        "bert_ring")
    if rel > 1e-5:
        raise AssertionError(f"bert_ring fp32 loss rel {rel}")
    return row


def phase_pipeline_mesh(kernel_fns, train_row):
    """The flagship (bf16, ``remat=False``) in two stages of 6 layers on
    ``pipeline=2`` over two positions of the card, GPipe over 4
    microbatches of 4 rows, 3 steps on the ``train`` phase's 16 x 1024
    batch and weights: the loss falls, step 1's loss is ``train``'s
    within ``BF16_LOSS_REL``, K3/K4/K5 launch 12 x 4 = 48 times a step
    each (every layer once a microbatch; the bubbles are not run), the
    copies stay byte-equal. Step ms and peak memory beside ``train``'s
    (one card: not a speed result)."""
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = flagship_config(remat=False, pipeline_stages=2,
                          pipeline_microbatches=PIPE_MICRO)
    mesh = mesh_lib.make_mesh(pipeline=2, devices=[CARD] * 2)
    B, S = TRAIN_BATCH
    batch = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=4))
    _, row = _mesh_training(
        "pipeline_mesh", functools.partial(transformer.init_params, cfg),
        transformer.logical_axes(cfg),
        train.plain_loss(transformer.loss_fn, cfg), mesh, batch,
        transformer.flops_per_token(cfg) * B * S, kernel_fns, lr=1e-3)
    row.update(dtype="bfloat16", batch=B, seq=S, layers=cfg.n_layers,
               stages=2, microbatches=cfg.microbatches,
               tokens_per_s=B * S / (row["step_ms"] / 1e3),
               train_step_ms=train_row["step_ms"],
               step_vs_train=row["step_ms"] / train_row["step_ms"],
               train_peak_memory_bytes=train_row["peak_memory_bytes"],
               train_step1_loss=train_row["losses"][0],
               step1_loss_rel=_rel(row["losses"][0], train_row["losses"][0]),
               tol_step1_loss_rel=BF16_LOSS_REL)
    emit(row)
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"pipeline_mesh loss did not fall: "
                             f"{row['losses']}")
    if row["step1_loss_rel"] > BF16_LOSS_REL:
        raise AssertionError(f"pipeline_mesh step 1 loss {row['losses'][0]}"
                             f" vs train {train_row['losses'][0]}")
    check_mesh_launches(row["launches"], BERT_KERNELS,
                        cfg.n_layers * cfg.microbatches, MESH_STEPS,
                        "pipeline_mesh")
    return row


def phase_pipeline_conformance(kernel_fns):
    """fp32, flagship width, 4 layers in 2 stages, 4 x 1024 over 2
    microbatches, on ``data=2, pipeline=2, tensor=2`` against the
    unsharded unpipelined step (:func:`mesh_conformance`): every layer
    runs once a microbatch on each data piece's 2 tensor shards."""
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    cfg = flagship_config("float32", n_layers=4, remat=False,
                          pipeline_stages=2, pipeline_microbatches=2)
    mesh = mesh_lib.make_mesh(data=2, pipeline=2, tensor=2,
                              devices=[CARD] * 8)
    return mesh_conformance(
        "pipeline_conformance", cfg,
        dataclasses.replace(cfg, pipeline_stages=0, pipeline_microbatches=0),
        mesh, kernel_fns, cfg.n_layers * 2 * 2 * cfg.microbatches, seed=23)


def flagship_1f1b_fns(cfg, row_aux=True):
    """The transformer as ``train_1f1b``'s three functions over fp32
    masters cast to ``cfg``'s dtype at use: ``embed_fn(ep, tokens)``,
    ``layer_fn(lp, x)`` (one layer, RoPE at positions ``arange(S)``; an
    MoE layer's aux in row form with ``row_aux``, the whole
    microbatch's, else a 0-d value that ``train_1f1b`` averages over the
    cuts) and ``loss_fn(hp, y, targets)`` (final norm, head, the mean of
    nll + z-loss over the microbatch)."""
    import torch
    from kubeflow_tpu_torch.compute.models import transformer
    dt = cfg.compute_dtype

    def embed_fn(ep, tokens):
        return ep["embed"].to(dt)[tokens.long()]

    def layer_fn(lp, x):
        rope = transformer.rope_tables(
            cfg, torch.arange(x.shape[1], device=x.device))
        return transformer._layer(transformer.flat_layer(
            {k: v.to(dt) for k, v in lp.items()}), x, rope, cfg,
            row_aux=row_aux)

    def loss_fn(hp, y, targets):
        x = transformer._rmsnorm(y, hp["final_norm"].to(dt))
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
        terms = transformer._loss_terms(x, hp["head"].to(dt),
                                        targets.long(), mask, cfg)
        return terms["loss"] / terms["count"]

    return embed_fn, layer_fn, loss_fn


def _1f1b_params(params):
    """A transformer params tree as ``train_1f1b``'s ``{"embed",
    "layers", "head"}``."""
    return {"embed": {"embed": params["embed"]}, "layers": params["layers"],
            "head": {"final_norm": params["final_norm"],
                     "head": params["head"]}}


def phase_pipeline_1f1b(kernel_fns):
    """The flagship's 12 layers (bf16) through ``train_1f1b`` on
    ``pipeline=2``, 16 x 1024 in 8 microbatches, beside the GPipe
    gradient of the same weights and batch at the same M (the mesh loss
    and ``autograd.grad``, no update): the loss within
    ``BF16_LOSS_REL`` of GPipe's, peak memory below GPipe's, K3 2 x 12
    x 8 = 192 (the forward and the recompute), K4/K5 96 (each schedule
    called twice, the second call's numbers kept). Then both on
    ``data=2 x pipeline=2`` (each microbatch cut in two over ``data``):
    the 1F1B loss within ``BF16_LOSS_REL`` of the pipeline-only 1F1B's
    and of GPipe's on that mesh, K3 2 x 12 x 8 x 2 = 384, K4/K5 192,
    live inputs <= 3. Then fp32 at 2 layers (one a stage): 4 x 1024 in 4
    microbatches on ``pipeline=2``, 8 x 1024 in 4 on ``data=2 x
    pipeline=2`` and on ``data=2 x pipeline=2 x tensor=2`` (the weights
    placed over ``tensor``, gathered at each stage's lead): the loss
    within 1e-5 relative and each leaf's gradient within 1e-3 of its max
    |g| of plain autograd through the same three functions."""
    import torch
    from kubeflow_tpu_torch.compute import (data, mesh as mesh_lib,
                                            pipeline, sharding, train)
    from kubeflow_tpu_torch.compute.models import transformer
    t_phase = time.perf_counter()
    cfg = flagship_config(remat=False, pipeline_stages=2,
                          pipeline_microbatches=F1B_MICRO)
    mesh = mesh_lib.make_mesh(pipeline=2, devices=[CARD] * 2)
    B, S = TRAIN_BATCH
    host = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=4))
    weights = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    params = sharding.place_tree(weights, mesh, transformer.logical_axes(cfg))
    pieces = sharding.pieces_of(train.tree_leaves(params))
    for t in pieces:
        t.requires_grad_(True)
    runs = {}
    # two rounds: a schedule's first call meets cold shapes, so the
    # second's time and memory are kept (the first's ms beside them)
    for name in ("gpipe", "1f1b") * 2:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero(kernel_fns)
        t0 = time.perf_counter()
        if name == "gpipe":
            loss, _ = transformer.loss_fn(params,
                                          data.shard_batch(host, mesh), cfg)
            grads = train._grads(loss, pieces)
        else:
            loss, grads = pipeline.train_1f1b(
                *flagship_1f1b_fns(cfg), _1f1b_params(params),
                torch.from_numpy(host["tokens"]),
                torch.from_numpy(host["targets"]), F1B_MICRO, mesh)
        torch.cuda.synchronize()
        first = runs.get(name, {}).get("ms")
        runs[name] = {"loss": float(loss.detach()),
                      "ms": 1e3 * (time.perf_counter() - t0),
                      "first_ms": first,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "resident_bytes": resident,
                      "launches": _launches(kernel_fns)}
        del loss, grads
    runs["1f1b"]["live_inputs"] = pipeline.train_1f1b.live_inputs
    launches = runs["1f1b"]["launches"]
    del params, pieces
    torch.cuda.empty_cache()
    data_mesh = mesh_lib.make_mesh(data=2, pipeline=2, devices=[CARD] * 4)
    params = sharding.place_tree(weights, data_mesh,
                                 transformer.logical_axes(cfg))
    del weights
    pieces = sharding.pieces_of(train.tree_leaves(params))
    for t in pieces:
        t.requires_grad_(True)
    on_data = {}
    for name in ("gpipe", "1f1b"):
        _zero(kernel_fns)
        t0 = time.perf_counter()
        if name == "gpipe":
            loss, _ = transformer.loss_fn(
                params, data.shard_batch(host, data_mesh), cfg)
            grads = train._grads(loss, pieces)
        else:
            loss, grads = pipeline.train_1f1b(
                *flagship_1f1b_fns(cfg), _1f1b_params(params),
                torch.from_numpy(host["tokens"]),
                torch.from_numpy(host["targets"]), F1B_MICRO, data_mesh)
        torch.cuda.synchronize()
        on_data[name] = {"loss": float(loss.detach()),
                         "ms": 1e3 * (time.perf_counter() - t0),
                         "launches": _launches(kernel_fns)}
        del loss, grads
    on_data["1f1b"]["live_inputs"] = pipeline.train_1f1b.live_inputs
    data_row = {"mesh": {"data": 2, "pipeline": 2}, **on_data,
                "launches": on_data["1f1b"]["launches"],
                "loss_rel_vs_pipeline_1f1b": _rel(on_data["1f1b"]["loss"],
                                                  runs["1f1b"]["loss"]),
                "loss_rel_vs_gpipe": _rel(on_data["1f1b"]["loss"],
                                          on_data["gpipe"]["loss"])}
    del params, pieces
    torch.cuda.empty_cache()
    fp32 = [_1f1b_fp32(mesh, 4),
            _1f1b_fp32(data_mesh, 8),
            _1f1b_fp32(mesh_lib.make_mesh(data=2, pipeline=2, tensor=2,
                                          devices=[CARD] * 8), 8)]
    row = {"phase": "pipeline_1f1b", "dtype": "bfloat16", "batch": B,
           "seq": S, "layers": cfg.n_layers, "stages": 2,
           "microbatches": F1B_MICRO, **runs,
           "loss_rel": _rel(runs["1f1b"]["loss"], runs["gpipe"]["loss"]),
           "tol_loss_rel": BF16_LOSS_REL,
           "peak_vs_gpipe": (runs["1f1b"]["peak_memory_bytes"]
                             / runs["gpipe"]["peak_memory_bytes"]),
           "launches": launches, "data": data_row, "fp32": fp32,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    if row["loss_rel"] > BF16_LOSS_REL:
        raise AssertionError(f"pipeline_1f1b loss {runs['1f1b']['loss']} vs "
                             f"GPipe {runs['gpipe']['loss']}")
    if not row["peak_vs_gpipe"] < 1:
        raise AssertionError(f"1F1B peak memory is not below GPipe's: "
                             f"{row['peak_vs_gpipe']}")
    check_mesh_launches(launches, ("flash_fwd",),
                        2 * cfg.n_layers * F1B_MICRO, 1, "pipeline_1f1b")
    check_mesh_launches(launches, ("flash_bwd_dq", "flash_bwd_dkv"),
                        cfg.n_layers * F1B_MICRO, 1, "pipeline_1f1b")
    if runs["1f1b"]["live_inputs"] > 3:
        raise AssertionError(f"1F1B held {runs['1f1b']['live_inputs']} "
                             f"stage inputs, more than 2P - 1 = 3")
    check_1f1b_data(data_row, cfg.n_layers, F1B_MICRO)
    for f in fp32:
        if f["loss_rel"] > 1e-5 or f["leaf_rel_max"] > 1e-3:
            raise AssertionError(f"pipeline_1f1b fp32: {f}")
    return row


def check_1f1b_data(row, layers, micro):
    """``pipeline_1f1b``'s ``data=2 x pipeline=2`` run: the loss within
    ``BF16_LOSS_REL`` of the pipeline-only 1F1B's and of GPipe's on
    that mesh, K3 ``2 x layers x micro x 2`` (the forward and the
    recompute of both cuts), K4/K5 ``layers x micro x 2``, at most 3
    stage inputs live."""
    for key in ("loss_rel_vs_pipeline_1f1b", "loss_rel_vs_gpipe"):
        if row[key] > BF16_LOSS_REL:
            raise AssertionError(f"pipeline_1f1b on data x pipeline: {key} "
                                 f"{row[key]}")
    check_mesh_launches(row["launches"], ("flash_fwd",),
                        2 * layers * micro * 2, 1, "pipeline_1f1b data")
    check_mesh_launches(row["launches"], ("flash_bwd_dq", "flash_bwd_dkv"),
                        layers * micro * 2, 1, "pipeline_1f1b data")
    if row["1f1b"]["live_inputs"] > 3:
        raise AssertionError(f"1F1B on data x pipeline held "
                             f"{row['1f1b']['live_inputs']} stage inputs, "
                             f"more than 2P - 1 = 3")


def _gang_rows(rows, mesh):
    """The slice of a global batch of ``rows`` that this process of
    ``mesh``'s gang feeds (all of it on one process)."""
    n = rows // mesh.process_count
    return slice(mesh.process_index * n, (mesh.process_index + 1) * n)


def _1f1b_fp32(mesh, rows):
    """fp32, flagship width, 2 layers, ``rows`` x 1024 in 4
    microbatches: ``train_1f1b`` on ``mesh`` (the weights placed by the
    model's logical axes; a gang's process feeding its rows) against
    plain autograd through the same functions on the whole batch."""
    import torch
    from kubeflow_tpu_torch.compute import data, pipeline, sharding, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = flagship_config("float32", n_layers=2, remat=False)
    host = next(data.synthetic_lm(rows, 1024, cfg.vocab_size, seed=24))
    tokens, targets = (torch.from_numpy(host[k]).to(CARD)
                       for k in ("tokens", "targets"))
    mine = _gang_rows(rows, mesh)
    weights = transformer.init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu")
    staged = dataclasses.replace(cfg, pipeline_stages=2,
                                 pipeline_microbatches=4)
    placed = _1f1b_params(sharding.place_tree(
        weights, mesh, transformer.logical_axes(staged)))
    params = _1f1b_params(train.tree_map(lambda t: t.to(CARD), weights))
    embed_fn, layer_fn, loss_fn = flagship_1f1b_fns(cfg)
    loss, grads = pipeline.train_1f1b(embed_fn, layer_fn, loss_fn, placed,
                                      tokens[mine], targets[mine], 4, mesh)
    grads = sharding.gather_tree(grads, CARD)
    leaves = train.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    x = embed_fn(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = layer_fn({k: v[i] for k, v in params["layers"].items()}, x)
    want = loss_fn(params["head"], x, targets)
    want_g = torch.autograd.grad(want, leaves)
    errs = _leaf_errors(train.tree_leaves(grads), want_g)
    return {"mesh": {a: n for a, n in mesh.shape.items() if n > 1},
            "processes": mesh.process_count,
            "layers": 2, "batch": [rows, 1024],
            "microbatches": 4,
            "loss": [float(loss), float(want.detach())],
            "loss_rel": _rel(float(loss), float(want.detach())),
            "tol_loss": 1e-5,
            "leaf_rel_max": max(errs), "tol_leaf": 1e-3}


#: the MoE aux check: fp32, 2 layers, rows x 1024 in microbatches, the
#: aux at the MoE loss's weight (JAX ``loss_fn``'s 0.01)
MOE_1F1B_BATCH, MOE_1F1B_MICRO, MOE_AUX_WEIGHT = (4, 1024), 2, 0.01


def _1f1b_moe(mesh, row_aux=True):
    """The MoE flagship (dropless on K6/K7) in fp32 at 2 layers through
    ``train_1f1b`` on ``mesh``, ``MOE_1F1B_BATCH`` (seed 26; a gang's
    process feeding its rows) in ``MOE_1F1B_MICRO`` microbatches with
    ``aux_weight`` ``MOE_AUX_WEIGHT``, the layers' aux in row form (or,
    without ``row_aux``, 0-d values averaged over the cuts) → ``(loss,
    gradient leaves gathered on the card)``."""
    import torch
    from kubeflow_tpu_torch.compute import data, pipeline, sharding, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = moe_config("float32", n_layers=2)
    host = next(data.synthetic_lm(*MOE_1F1B_BATCH, cfg.vocab_size, seed=26))
    mine = _gang_rows(MOE_1F1B_BATCH[0], mesh)
    weights = transformer.init_params(
        cfg, torch.Generator().manual_seed(5), device="cpu")
    staged = dataclasses.replace(cfg, scan_layers=True, pipeline_stages=2,
                                 pipeline_microbatches=MOE_1F1B_MICRO)
    placed = _1f1b_params(sharding.place_tree(
        weights, mesh, transformer.logical_axes(staged)))
    loss, grads = pipeline.train_1f1b(
        *flagship_1f1b_fns(cfg, row_aux), placed,
        torch.from_numpy(host["tokens"][mine]),
        torch.from_numpy(host["targets"][mine]), MOE_1F1B_MICRO, mesh,
        aux_weight=MOE_AUX_WEIGHT)
    return float(loss), train.tree_leaves(sharding.gather_tree(grads, CARD))


def moe_aux_report(got, want):
    """Two :func:`_1f1b_moe` results → the loss relative to ``want``'s
    and the worst leaf's max |Δg| over its max |g|."""
    return {"loss": [got[0], want[0]], "loss_rel": _rel(got[0], want[0]),
            "leaf_rel_max": max(_leaf_errors(got[1], want[1])),
            "tol_loss": 1e-5, "tol_leaf": 1e-3}


def check_moe_aux(report, what):
    """A :func:`moe_aux_report` within its tolerances."""
    if (report["loss_rel"] > report["tol_loss"]
            or report["leaf_rel_max"] > report["tol_leaf"]):
        raise AssertionError(f"{what}: {report}")


def phase_pipeline_1f1b_moe(kernel_fns):
    """The MoE aux through 1F1B on a cut microbatch: :func:`_1f1b_moe`
    on ``data=2 x pipeline=2`` (each microbatch cut in two, the layers'
    load-balancing aux in row form) against the same on ``pipeline=2``
    (no cut): the loss within 1e-5 relative and each leaf within 1e-3
    of its max |g|. Counts zeroed just before the ``data=2`` run and
    read just after: K3 ``2 x L x M x 2`` (forward and recompute), K4
    and K5 ``L x M x 2``, K6 ``6 x L x M x 2`` (gate|up and down in the
    forward, the recompute and the dx), K7 ``2 x L x M x 2``. Beside it,
    for the record, the loss when each layer's aux is the mean of the
    cuts' values (the rule before the row form)."""
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    t_phase = time.perf_counter()
    data_mesh = mesh_lib.make_mesh(data=2, pipeline=2, devices=[CARD] * 4)
    whole = _1f1b_moe(mesh_lib.make_mesh(pipeline=2, devices=[CARD] * 2))
    _zero(kernel_fns)
    cut = _1f1b_moe(data_mesh)
    launches = _launches(kernel_fns)
    mean_of_cuts = _1f1b_moe(data_mesh, row_aux=False)
    row = {"phase": "pipeline_1f1b_moe", "dtype": "float32", "layers": 2,
           "experts": 8, "batch": list(MOE_1F1B_BATCH),
           "microbatches": MOE_1F1B_MICRO, "aux_weight": MOE_AUX_WEIGHT,
           "mesh": {"data": 2, "pipeline": 2},
           **moe_aux_report(cut, whole),
           "mean_of_cuts": moe_aux_report(mean_of_cuts, whole),
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    emit(row)
    check_moe_aux(row, "pipeline_1f1b_moe")
    n = 2 * MOE_1F1B_MICRO * 2          # layers x microbatches x cuts
    check_mesh_launches(launches, ("flash_fwd",), 2 * n, 1,
                        "pipeline_1f1b_moe")
    check_mesh_launches(launches, ("flash_bwd_dq", "flash_bwd_dkv"), n, 1,
                        "pipeline_1f1b_moe")
    check_mesh_launches(launches, ("grouped_matmul",), 6 * n, 1,
                        "pipeline_1f1b_moe")
    check_mesh_launches(launches, ("grouped_matmul_dw",), 2 * n, 1,
                        "pipeline_1f1b_moe")
    return row


MOE_MESH_STEPS = MOE_WARM + MOE_TIMED
#: a bf16 step-1 number's relative gap from the one-device step's on the
#: same weights and batch (pieces and shards sum in another order); a
#: gang's losses are held to it at every step
STEP1_REL = 1e-3


def phase_moe_mesh(kernel_fns, moe_row):
    """The MoE flagship (``moe_config``: bf16, 8 experts top-2, dropless
    on K6/K7, flash) trained on ``data=2, expert=2`` over four positions
    of the card: each expert shard holds 4 experts, each data piece 4 x
    1024 of ``moe_train``'s 8 x 1024 batch and weights; 2 warm + 3 timed
    steps. The loss falls, step 1's loss and ``moe_aux`` are
    ``moe_train``'s within ``STEP1_REL`` (whether to the bit is printed),
    the copies stay byte-equal; K6 launches 4 a layer on every (piece,
    expert shard) holding rows — 2 x 2 x 4 x 8 = 128 a step —, K7 64, and
    K3–K5 once a layer a piece, 16. Step ms, tokens/s and peak memory
    (one card runs the shards in turn: not a speed result)."""
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = moe_config()
    mesh = mesh_lib.make_mesh(data=2, expert=2, devices=[CARD] * 4)
    B, S = MOE_BATCH
    batch = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=7))
    _, row = _mesh_training(
        "moe_mesh", functools.partial(transformer.init_params, cfg),
        # the port stacks the layers whatever scan_layers says
        transformer.logical_axes(dataclasses.replace(cfg, scan_layers=True)),
        train.plain_loss(transformer.loss_fn, cfg), mesh, batch,
        transformer.flops_per_token(cfg) * B * S, kernel_fns, lr=1e-3,
        steps=MOE_MESH_STEPS)
    timed = row["step_ms_each"][-MOE_TIMED:]
    pieces, shards = 2, 2
    want = {"grouped_matmul": pieces * shards * 4 * cfg.n_layers,
            "grouped_matmul_dw": pieces * shards * 2 * cfg.n_layers,
            "flash_fwd": pieces * cfg.n_layers,
            "flash_bwd_dq": pieces * cfg.n_layers,
            "flash_bwd_dkv": pieces * cfg.n_layers}
    row.update(dtype="bfloat16", batch=B, seq=S, layers=cfg.n_layers,
               experts=cfg.moe_experts, experts_per_shard=cfg.moe_experts
               // shards, top_k=cfg.moe_top_k,
               params=transformer.param_count(cfg),
               step_ms=statistics.mean(timed), step_ms_timed=timed,
               tokens_per_s=B * S / (statistics.mean(timed) / 1e3),
               moe_train_step_ms=moe_row["step_ms"],
               moe_train_peak_memory_bytes=moe_row["peak_memory_bytes"],
               moe_train_step1=[moe_row["losses"][0], moe_row["moe_aux"][0]],
               step1_loss_rel=_rel(row["losses"][0], moe_row["losses"][0]),
               step1_aux_rel=_rel(row["moe_aux"][0], moe_row["moe_aux"][0]),
               step1_bit_equal=(row["losses"][0] == moe_row["losses"][0]
                                and row["moe_aux"][0]
                                == moe_row["moe_aux"][0]),
               tol_step1_rel=STEP1_REL, launches_want_per_step=want)
    emit(row)
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"moe_mesh loss did not fall: {row['losses']}")
    if max(row["step1_loss_rel"], row["step1_aux_rel"]) > STEP1_REL:
        raise AssertionError(f"moe_mesh step 1 ({row['losses'][0]}, "
                             f"{row['moe_aux'][0]}) vs moe_train "
                             f"{row['moe_train_step1']}")
    for name, n in want.items():
        check_mesh_launches(row["launches"], (name,), n, MOE_MESH_STEPS,
                            "moe_mesh")
    return row


def phase_moe_mesh_conformance(kernel_fns):
    """fp32 (TF32 off), MoE flagship widths, 2 layers, 4 x 1024, on
    ``data=2, expert=2, tensor=2`` over eight positions of the card
    against one device (K6/K7 on both sides; :func:`mesh_conformance`,
    loss within 1e-6 relative, leaves within 1e-5 of their max |g|):
    dropless top-2 in 2 GPipe stages of 2 microbatches (both stages at
    pipeline coordinate 0 of this mesh; the aux grouped by the global
    microbatches), and the capacity dispatch (top-2) without stages."""
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(data=2, expert=2, tensor=2,
                              devices=[CARD] * 8)
    staged = moe_config("float32", n_layers=2, scan_layers=True,
                        pipeline_stages=2, pipeline_microbatches=2)
    capacity = moe_config("float32", n_layers=2, moe_dropless=False)
    attending = mesh.size // mesh.shape["expert"]   # pieces × tensor
    return [mesh_conformance(
        f"moe_mesh_conformance_{tag}", cfg, cfg, mesh, kernel_fns,
        attending * cfg.n_layers * (cfg.microbatches
                                    if cfg.pipeline_stages > 1 else 1),
        seed=25, tol_loss=1e-6, tol_leaf=1e-5)
        for tag, cfg in (("dropless_gpipe", staged),
                         ("capacity", capacity))]


PROCESS_STEPS = 4
PROCESS_TIMEOUT_S = 600
#: a collective of fewer elements is a statistic's (a loss term's sums,
#: ResNet's ``[2, C]`` BN moments and their gradients), not a gradient
#: bucket's
SMALL_COLLECTIVE = 1 << 16
#: the models a ``process_mesh`` rank trains, in order
PROCESS_MODELS = ("flagship", "bert", "resnet")


def _digest(tensors):
    """Two int64 sums of every fp32 tensor's bits (plain and weighted by
    position), order-free and exact: equal on two processes whose
    tensors are byte-equal."""
    import torch
    out = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) % 7919 + 1
        out += [bits.sum(), (bits * w).sum()]
    return torch.stack(out).cpu()


def _params_digest(state):
    """:func:`_digest` of every param and model-state piece."""
    from kubeflow_tpu_torch.compute import sharding, train
    return _digest(sharding.pieces_of(train.tree_leaves(state.params)
                                      + train.tree_leaves(state.extra)))


def _gang_equal(digest):
    """Whether this rank's ``digest`` equals the other rank's (the digest
    ``all_reduce``d MAX and MIN)."""
    import torch
    import torch.distributed as dist
    hi, lo = digest.clone(), digest.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def _rank_case(name, rank):
    """What rank ``rank`` trains for ``name`` → ``(init_fn, logical
    axes, loss, its half of the one-device phase's batch, lr, extra)``:
    the weights, batch and rate of the ``train``, ``bert_train`` or
    ``resnet_train`` phase."""
    import torch
    from kubeflow_tpu_torch.compute import data, train
    from kubeflow_tpu_torch.compute.models import bert, resnet, transformer
    extra = None
    if name == "flagship":
        cfg = flagship_config(remat=False)
        host = next(data.synthetic_lm(*TRAIN_BATCH, cfg.vocab_size, seed=4))
        case = (functools.partial(transformer.init_params, cfg),
                transformer.logical_axes(cfg),
                train.plain_loss(transformer.loss_fn, cfg), host, 1e-3)
    elif name == "bert":
        cfg = bert.Config(remat=False, scan_layers=False)
        host = bert.mlm_batch(np.random.default_rng(13), BERT_BATCH, cfg)
        case = (functools.partial(bert.init_params, cfg),
                bert.logical_axes(cfg), train.plain_loss(bert.loss_fn, cfg),
                host, 1e-4)
    else:
        cfg = resnet.Config(depth=50, n_classes=1000, dtype="bfloat16")
        params, extra = resnet.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        host = next(data.synthetic_images(RESNET_BATCH, RESNET_IMAGE,
                                          cfg.n_classes, seed=12))
        case = (lambda g, device: params, resnet.logical_axes(cfg)[0],
                train.stateful_loss(resnet.loss_fn, cfg), host, 1e-3)
    init_fn, axes, loss, host, lr = case
    half = len(next(iter(host.values()))) // 2
    mine = {k: v[rank * half:(rank + 1) * half] for k, v in host.items()}
    return init_fn, axes, loss, mine, lr, extra


def _rank_train(name, rank, mesh, kernel_fns):
    """``PROCESS_STEPS`` steps of ``name`` on this rank's part of the
    gang's mesh; after each, whether the ranks are byte-equal → the
    rank's row for ``name``. Every step times its gradient
    ``all_reduce`` (a sync before and after); the last step alone also
    times each small collective (a sync around each), so the steps
    before it keep their own time."""
    import torch
    import torch.distributed as dist
    from kubeflow_tpu_torch.compute import train
    init_fn, axes, loss, mine, lr, extra = _rank_case(name, rank)
    opt = train.make_optimizer(learning_rate=lr, warmup_steps=1,
                               total_steps=100)
    state = train.init_state(init_fn, opt, mesh=mesh, logical_axes=axes,
                             generator=torch.Generator().manual_seed(0),
                             extra=extra)
    step = train.make_train_step(loss, opt, mesh)
    reduce_s = []
    plain_all_reduce = train._all_reduce

    def timed_all_reduce(tensors, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_all_reduce(tensors, group)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    small = [None]      # the last step's small collectives: [seconds, count]
    plain_collective = dist.all_reduce

    def timed_collective(tensor, *args, **kwargs):
        if tensor.numel() >= SMALL_COLLECTIVE or small[-1] is None:
            return plain_collective(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_collective(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        small[-1][0] += time.perf_counter() - t0
        small[-1][1] += 1
        return out

    train._all_reduce = timed_all_reduce
    dist.all_reduce = timed_collective
    _zero(kernel_fns)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, equal = [], [], []
    try:
        for i in range(PROCESS_STEPS):
            dist.barrier()
            if i == PROCESS_STEPS - 1:
                small.append([0.0, 0])
            t0 = time.perf_counter()
            state, metrics = step(state, mine)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            small.append(None)          # the digest's are not the step's
            equal.append(_gang_equal(_params_digest(state)))
    finally:
        train._all_reduce = plain_all_reduce
        dist.all_reduce = plain_collective
    grad_bytes = sum(t.numel() * 4 for t in train.tree_leaves(state.params)
                     for t in t.pieces[:1])
    row = {"model": name, "rank": rank, "batch_per_rank":
           len(next(iter(mine.values()))), "losses": losses,
           "step_ms_each": [1e3 * x for x in step_s],
           "all_reduce_ms_each": [1e3 * x for x in reduce_s],
           "small_collective_ms": 1e3 * small[-2][0],
           "small_collectives_a_step": small[-2][1],
           "grad_bytes": grad_bytes, "params_equal_each_step": equal,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": _launches(kernel_fns)}
    del state, step
    torch.cuda.empty_cache()
    return row


def _resnet_fp32_sides(batch, lr, mesh=None):
    """ResNet-50 fp32 fed ``batch`` (host arrays) on ``mesh``, or
    unsharded on the card when None: one step at rate ``lr`` (warmup 0)
    from the seed-15 weights with every BN quantity randomised (each
    block's branch live) and one from the seed-15 init → ``(loss,
    running statistics, pre-clip grad norm, params after the update)``,
    the last three as host leaves. The gradient is read at the init:
    with every BN randomised each fp32 gradient, on one device or a
    mesh, lies a fifth of a leaf's max |g| off the float64 one; at init
    the grad norm and the update's signs compare, a leaf's fp32 gradient
    does not (on one device the third stage's lie 9 % of their max |g|
    off the float64 gradient, a mesh's 4e-4: hack/resnet_mesh_grads.py).
    """
    import torch
    from kubeflow_tpu_torch.compute import data, sharding, train
    from kubeflow_tpu_torch.compute.models import resnet
    cfg = resnet.Config(depth=50, n_classes=1000, dtype="float32")
    loss = train.stateful_loss(resnet.loss_fn, cfg)
    if mesh is None:
        where, batch = dict(device=CARD), data.to_device(batch, CARD)
    else:
        where = dict(mesh=mesh, logical_axes=resnet.logical_axes(cfg)[0])
        batch = data.shard_batch(batch, mesh)

    def stepped(weights):
        opt = train.make_optimizer(learning_rate=lr, warmup_steps=0,
                                   total_steps=100)
        st = train.init_state(
            lambda g, device: train.tree_map(torch.clone, weights[0]), opt,
            extra=train.tree_map(torch.clone, weights[1]), **where)
        return train.make_train_step(loss, opt, mesh=mesh)(st, batch)

    st, m = stepped(resnet_weights(cfg, seed=15, device="cpu"))
    out = [float(m["loss"]),
           train.tree_leaves(sharding.gather_tree(st.extra, "cpu"))]
    del st
    st, m = stepped(resnet.init_params(
        cfg, torch.Generator().manual_seed(15), device="cpu"))
    out += [float(m["grad_norm"]),
            train.tree_leaves(train.gather_params(st, "cpu"))]
    del st
    torch.cuda.empty_cache()
    return out


def resnet_fp32_report(got, want, lr):
    """Two :func:`_resnet_fp32_sides` results → the fp32 sync-BN report:
    ``got``'s loss, running statistics (each of its leaf's max |value|)
    and pre-clip gradient norm relative to ``want``'s, and the params
    after the update by :func:`params_rule` over all elements."""
    (g_loss, g_stats, g_norm, g_params), (w_loss, w_stats, w_norm,
                                          w_params) = got, want
    worst, share, ok = params_rule(g_params, w_params, lr, 1,
                                   whole_model=True)
    return {"depth": 50, "images": 8, "loss": [g_loss, w_loss],
            "loss_rel": abs(g_loss - w_loss) / abs(w_loss),
            "stats_rel_max": max(_leaf_errors(g_stats, w_stats)),
            "tol": 1e-5, "init_grad_norm": [g_norm, w_norm],
            "init_grad_norm_rel": abs(g_norm - w_norm) / abs(w_norm),
            "params_max_abs": worst, "params_share_over_1e-6": share,
            "params_rule_ok": ok,
            "params_rule": {"max_abs": 2 * lr, "share": 1e-3,
                            "over": "all elements"}}


def check_resnet_fp32(report, what):
    """A :func:`resnet_fp32_report` (and, for a gang, the ranks'
    byte-equality): loss, running statistics and pre-clip gradient norm
    within its ``tol`` relative, the params by ``params_rule``."""
    if (not report.get("ranks_equal", True)
            or report["loss_rel"] > report["tol"]
            or report["stats_rel_max"] > report["tol"]
            or report["init_grad_norm_rel"] > report["tol"]
            or not report["params_rule_ok"]):
        raise AssertionError(f"{what}: {report}")


def _rank_resnet_fp32(rank, mesh):
    """The fp32 sync-BN check across the gang: ResNet-50 on 8 images, 4
    a rank, :func:`_resnet_fp32_sides` at rate 1e-3; the ranks'
    byte-equality by digest; rank 0 then takes the same steps on a
    one-process ``data=2`` mesh over the whole batch and holds the gang
    to it, as ``resnet_mesh`` holds its mesh → the report (rank 0's) or
    None."""
    import torch
    import torch.distributed as dist
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib
    t0 = time.perf_counter()
    host = next(data.synthetic_images(8, RESNET_IMAGE, 1000, seed=16))
    mine = {k: v[rank * 4:(rank + 1) * 4] for k, v in host.items()}
    gang = _resnet_fp32_sides(mine, 1e-3, mesh)
    g_loss, g_stats, g_norm, g_params = gang
    digest = torch.stack([
        torch.cat([t.reshape(-1) for t in g_stats + g_params]).view(
            torch.int32).long().sum(),
        torch.tensor(g_loss).view(torch.int32).long(),
        torch.tensor(g_norm, dtype=torch.float32).view(torch.int32).long()])
    hi, lo = digest.clone(), digest.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    ranks_equal = bool(torch.equal(hi, lo))
    if rank:
        return None
    one = mesh_lib.make_mesh(data=2, devices=[CARD] * 2)
    report = resnet_fp32_report(gang, _resnet_fp32_sides(host, 1e-3, one),
                                1e-3)
    return {**report, "images_per_rank": 4, "ranks_equal": ranks_equal,
            "seconds": time.perf_counter() - t0}


def process_mesh_rank(rank, port, out):
    """One rank of :func:`phase_process_mesh` (``python3 chip_smoke.py
    --process-mesh-rank RANK PORT OUT``): on its part of a ``data=2``
    mesh across two gloo processes on ``cuda:0``, the flagship (its 8
    rows of the 16 x 1024 batch), bert-base (8 of 16 x 512) and
    ResNet-50 (128 of 256 x 224²), ``PROCESS_STEPS`` steps each, the
    params' (and statistics') digest against the other rank's after
    each (``all_reduce`` MAX and MIN); then the fp32 ResNet gang check
    (:func:`_rank_resnet_fp32`). Writes its rows to ``out``."""
    import torch
    import torch.distributed as dist
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(data=-1), devices=[CARD],
                              group=dist.group.WORLD)
    kernel_fns = {"flash_fwd": flash_ops.flash_attention,
                  "flash_bwd_dq": flash_ops.flash_attention_bwd_dq,
                  "flash_bwd_dkv": flash_ops.flash_attention_bwd_dkv}
    rows = {"rank": rank, "backend": dist.get_backend()}
    for name in PROCESS_MODELS:
        rows[name] = _rank_train(name, rank, mesh, kernel_fns)
    rows["resnet_fp32"] = _rank_resnet_fp32(rank, mesh)
    with open(out, "w") as f:
        json.dump(rows, f)
    dist.destroy_process_group()


REPO = os.path.dirname(os.path.abspath(__file__))


def _scratch(prefix):
    """A fresh directory under the git-ignored ``build/``."""
    import tempfile
    os.makedirs(f"{REPO}/build", exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=f"{REPO}/build")


def _tail(path, n=3000):
    with open(path) as f:
        return f.read()[-n:]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_all(procs, timeout):
    """Wait for every process, each within ``timeout`` s → return codes;
    kills them all on the way out (a hung rank fails the phase)."""
    try:
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _gang_row(name, ranks, one_row):
    """``process_mesh``'s row for model ``name`` from the ranks' rows,
    beside the one-process phase's row ``one_row``: the step and its
    gradient ``all_reduce`` as the mean of the steps between the first
    and the last, the small collectives' share of the last step, and
    each step's loss relative to the one-process phase's same step."""
    mine = [r[name] for r in ranks]
    steps = [statistics.mean(r["step_ms_each"][1:-1]) for r in mine]
    reduces = [statistics.mean(r["all_reduce_ms_each"][1:-1])
               for r in mine]
    return {"model": name, "batch_per_rank": mine[0]["batch_per_rank"],
            "ranks": mine, "step_ms": statistics.mean(steps),
            "all_reduce_ms": statistics.mean(reduces),
            "all_reduce_share": statistics.mean(
                a / b for a, b in zip(reduces, steps)),
            "small_collectives_a_step": mine[0]["small_collectives_a_step"],
            "small_collective_ms": statistics.mean(
                r["small_collective_ms"] for r in mine),
            "small_collective_share": statistics.mean(
                r["small_collective_ms"] / r["step_ms_each"][-1]
                for r in mine),
            "grad_bytes_per_rank": mine[0]["grad_bytes"],
            "one_process_step_ms": one_row["step_ms"],
            "one_process_losses": one_row["losses"][:PROCESS_STEPS],
            "loss_rel_each": [_rel(a, b) for a, b in zip(
                mine[0]["losses"], one_row["losses"][:PROCESS_STEPS])]}


def check_gang(row, kernels=(), per_step=0):
    """The checks of one model's ``process_mesh`` row: the ranks
    byte-equal after every step, equal losses, each of the
    ``PROCESS_STEPS`` losses within ``STEP1_REL`` of the one-process
    phase's same step (the same batch, rate and warmup: a gradient
    wrong alike on both ranks moves steps 2 on), each of ``kernels``
    launched ``per_step`` times a step on each rank."""
    name, ranks = row["model"], row["ranks"]
    if not all(all(r["params_equal_each_step"]) for r in ranks):
        raise AssertionError(f"process_mesh {name}: the ranks' params "
                             f"differ")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"process_mesh {name}: the ranks report other "
                             f"losses: {[r['losses'] for r in ranks]}")
    rels = row["loss_rel_each"]
    if len(rels) != PROCESS_STEPS or max(rels) > STEP1_REL:
        raise AssertionError(f"process_mesh {name} losses "
                             f"{ranks[0]['losses']} vs one process "
                             f"{row['one_process_losses']}")
    for r in ranks:
        check_mesh_launches(r["launches"], kernels, per_step, PROCESS_STEPS,
                            f"process_mesh {name} rank {r['rank']}")


def phase_process_mesh(one_rows, kernel_names):
    """Two processes on ``cuda:0`` joined over gloo, ``data=2`` across
    them (:func:`process_mesh_rank`, one subprocess pair): the flagship
    (bf16, ``remat=False``) of ``train``, bert-base of ``bert_train`` and
    ResNet-50 of ``resnet_train``, each rank feeding half of that
    phase's batch, ``PROCESS_STEPS`` steps each. Per model: the ranks'
    params (and running statistics) byte-equal after every step, equal
    losses, each step's within ``STEP1_REL`` of the one-process phase's
    (``one_rows`` by model), the flagship and BERT launching K3–K5 12 a
    step on each rank; step ms and the gradient ``all_reduce``'s share
    of it (fp32
    gradients through the host: gloo; two ranks on one card, so not a
    speed result). Then ResNet-50 fp32 across the ranks against the
    one-process ``data=2`` mesh (:func:`check_resnet_fp32`). →
    the row, its ``launches`` both ranks' (every kernel of
    ``kernel_names``)."""
    import subprocess
    t_phase = time.perf_counter()
    port = _free_port()
    outdir = _scratch("process-mesh-")
    outs = [f"{outdir}/rank{r}.json" for r in range(2)]
    procs = []
    for r in range(2):
        with open(f"{outdir}/rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--process-mesh-rank", str(r),
                 str(port), outs[r]], stdout=log, stderr=subprocess.STDOUT,
                cwd=REPO))
    codes = _run_all(procs, PROCESS_TIMEOUT_S)
    if codes != [0, 0]:
        logs = [_tail(f"{outdir}/rank{r}.log") for r in (0, 1)]
        raise AssertionError(f"process_mesh ranks exited {codes}: {logs}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    models = {name: _gang_row(name, ranks, one_rows[name])
              for name in PROCESS_MODELS}
    launches = {k: sum(r[name]["launches"].get(k, 0) for r in ranks
                       for name in PROCESS_MODELS) for k in kernel_names}
    row = {"phase": "process_mesh", "processes": 2,
           "backend": ranks[0]["backend"], "mesh": {"data": 2},
           "device": CARD, "steps": PROCESS_STEPS,
           "dtype": "bfloat16", "models": models,
           "resnet_fp32": ranks[0]["resnet_fp32"],
           "tol_loss_rel": STEP1_REL, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    check_gang(models["flagship"], BERT_KERNELS, 12)
    check_gang(models["bert"], BERT_KERNELS, 12)
    check_gang(models["resnet"])
    check_resnet_fp32(row["resnet_fp32"], "process_mesh fp32 ResNet gang")
    return row


F1B_GANG_CALLS = 3


def _rank_1f1b_bf16(rank, mesh, kernel_fns):
    """``pipeline_1f1b``'s bf16 workload (the flagship's 12 layers, 16 x
    1024 from seed 4 in ``F1B_MICRO`` microbatches, seed-0 weights) on
    this rank's part of the gang's ``data=2 x pipeline=2``, fed its own
    8 rows, ``F1B_GANG_CALLS`` times: the first meets cold shapes; the
    counts are zeroed just before the second and read just after, which
    is timed as it runs; the third syncs around each of the gang's joins
    and sums and times it (``pipeline._gang_cat`` of the token ids: the
    exchange; of the last stage's outputs: a join; the gradient
    ``train._all_reduce``) → the rank's row: loss, gradient digest equal
    to the other rank's, ms, the collectives' ms, live inputs,
    launches."""
    import torch
    import torch.distributed as dist
    from kubeflow_tpu_torch.compute import data, pipeline, sharding, train
    from kubeflow_tpu_torch.compute.models import transformer
    cfg = flagship_config(remat=False, pipeline_stages=2,
                          pipeline_microbatches=F1B_MICRO)
    B, S = TRAIN_BATCH
    host = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=4))
    mine = {k: torch.from_numpy(v[_gang_rows(B, mesh)])
            for k, v in host.items()}
    params = _1f1b_params(sharding.place_tree(
        transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu"),
        mesh, transformer.logical_axes(cfg)))
    plain_reduce, plain_cat = train._all_reduce, pipeline._gang_cat
    spans = {}          # the third call's: kind → [seconds, count]

    def synced(kind, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        span = spans.setdefault(kind, [0.0, 0])
        span[0] += time.perf_counter() - t0
        span[1] += 1
        return out

    def timed_reduce(*args):
        return synced("grad_all_reduce", plain_reduce, *args)

    def timed_cat(mine, *args):
        kind = "join" if mine[0].is_floating_point() else "exchange"
        return synced(kind, plain_cat, mine, *args)

    ms, row = [], {}
    for call in range(F1B_GANG_CALLS):
        if call == 1:
            _zero(kernel_fns)
        if call == F1B_GANG_CALLS - 1:
            train._all_reduce, pipeline._gang_cat = timed_reduce, timed_cat
        dist.barrier()
        t0 = time.perf_counter()
        try:
            loss, grads = pipeline.train_1f1b(
                *flagship_1f1b_fns(cfg), params, mine["tokens"],
                mine["targets"], F1B_MICRO, mesh)
            torch.cuda.synchronize()
        finally:
            train._all_reduce, pipeline._gang_cat = plain_reduce, plain_cat
        ms.append(1e3 * (time.perf_counter() - t0))
        if call == 1:
            row = {"loss": float(loss.detach()),
                   "live_inputs": pipeline.train_1f1b.live_inputs,
                   "launches": _launches(kernel_fns),
                   "grads_equal": _gang_equal(_digest(
                       sharding.pieces_of(train.tree_leaves(grads))))}
        del loss, grads
    return {**row, "rank": rank, "batch_per_rank": B // 2,
            "ms_each": ms, "ms": ms[1],
            "collectives": {k: {"ms": 1e3 * v[0], "count": v[1],
                                "share": 1e3 * v[0] / ms[-1]}
                            for k, v in spans.items()}}


def _rank_1f1b_moe(rank, mesh):
    """The MoE aux check across the gang: :func:`_1f1b_moe` on this
    rank's part of ``data=2 x pipeline=2``; rank 0 then runs it on one
    process's ``pipeline=2`` (no cut) and holds the gang to it → the
    report (rank 0's) or None."""
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    gang = _1f1b_moe(mesh)
    if rank:
        return None
    whole = _1f1b_moe(mesh_lib.make_mesh(pipeline=2, devices=[CARD] * 2))
    return moe_aux_report(gang, whole)


def pipeline_1f1b_gang_rank(rank, port, out):
    """One rank of :func:`phase_pipeline_1f1b_gang` (``python3
    chip_smoke.py --pipeline-1f1b-gang-rank RANK PORT OUT``): on its part
    of a ``data=2 x pipeline=2`` mesh across two gloo processes on
    ``cuda:0`` (``data=1 x pipeline=2`` each), the bf16 flagship
    (:func:`_rank_1f1b_bf16`), the fp32 side at 2 layers against plain
    autograd on the whole batch (:func:`_1f1b_fp32`, 4 rows a rank) and
    the MoE aux check (:func:`_rank_1f1b_moe`). Writes its row to
    ``out``."""
    import torch
    import torch.distributed as dist
    from kubeflow_tpu_torch.compute import mesh as mesh_lib
    from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(data=-1, pipeline=2),
                              devices=[CARD] * 2, group=dist.group.WORLD)
    kernel_fns = {"flash_fwd": flash_ops.flash_attention,
                  "flash_bwd_dq": flash_ops.flash_attention_bwd_dq,
                  "flash_bwd_dkv": flash_ops.flash_attention_bwd_dkv}
    row = {"backend": dist.get_backend(),
           **_rank_1f1b_bf16(rank, mesh, kernel_fns)}
    torch.cuda.empty_cache()
    row["fp32"] = _1f1b_fp32(mesh, 8)
    torch.cuda.empty_cache()
    row["moe"] = _rank_1f1b_moe(rank, mesh)
    with open(out, "w") as f:
        json.dump(row, f)
    dist.destroy_process_group()


def gang_1f1b_row(ranks, one_row, kernel_names):
    """``pipeline_1f1b_gang``'s row from its two ranks' rows, beside
    ``pipeline_1f1b``'s one-process ``data=2 x pipeline=2`` row
    ``one_row``: the ranks' losses, whether their gradients are
    byte-equal, the loss relative to one process's, ms and its ratio,
    each collective's mean share of the synced call, live inputs, the
    fp32 side and MoE check (rank 0's reports) and ``launches`` summed
    over the ranks for every kernel of ``kernel_names``."""
    ms = statistics.mean(r["ms"] for r in ranks)
    kinds = sorted({k for r in ranks for k in r["collectives"]})
    return {"phase": "pipeline_1f1b_gang", "processes": 2,
            "backend": ranks[0]["backend"],
            "mesh": {"data": 2, "pipeline": 2, "data_per_rank": 1},
            "dtype": "bfloat16", "batch": 2 * ranks[0]["batch_per_rank"],
            "batch_per_rank": ranks[0]["batch_per_rank"],
            "losses": [r["loss"] for r in ranks],
            "ranks_equal": all(r["grads_equal"] for r in ranks),
            "one_process_loss": one_row["1f1b"]["loss"],
            "loss_rel": _rel(ranks[0]["loss"], one_row["1f1b"]["loss"]),
            "tol_loss_rel": BF16_LOSS_REL, "ms": ms,
            "one_process_ms": one_row["1f1b"]["ms"],
            "vs_one_process": ms / one_row["1f1b"]["ms"],
            "collectives": {k: {
                "ms": statistics.mean(r["collectives"].get(k, {}).get(
                    "ms", 0.0) for r in ranks),
                "count": ranks[0]["collectives"].get(k, {}).get("count", 0),
                "share": statistics.mean(r["collectives"].get(k, {}).get(
                    "share", 0.0) for r in ranks)} for k in kinds},
            "live_inputs": max(r["live_inputs"] for r in ranks),
            "launches_each": [r["launches"] for r in ranks],
            "launches": {k: sum(r["launches"].get(k, 0) for r in ranks)
                         for k in kernel_names},
            "fp32": ranks[0]["fp32"], "moe": ranks[0]["moe"]}


def check_1f1b_gang(row, layers, micro):
    """``pipeline_1f1b_gang``'s checks: the ranks' losses equal and their
    gradients byte-equal, the loss within ``BF16_LOSS_REL`` of one
    process's ``data=2 x pipeline=2``, on each rank K3 ``2 x layers x
    micro`` and K4/K5 ``layers x micro``, at most 3 stage inputs live,
    the fp32 side and the MoE check within their tolerances."""
    if not row["ranks_equal"] or len(set(row["losses"])) != 1:
        raise AssertionError(f"pipeline_1f1b_gang: the ranks differ: "
                             f"losses {row['losses']}, gradients equal "
                             f"{row['ranks_equal']}")
    if row["loss_rel"] > row["tol_loss_rel"]:
        raise AssertionError(f"pipeline_1f1b_gang loss {row['losses'][0]} "
                             f"vs one process {row['one_process_loss']}")
    for r, launches in enumerate(row["launches_each"]):
        check_mesh_launches(launches, ("flash_fwd",), 2 * layers * micro, 1,
                            f"pipeline_1f1b_gang rank {r}")
        check_mesh_launches(launches, ("flash_bwd_dq", "flash_bwd_dkv"),
                            layers * micro, 1, f"pipeline_1f1b_gang rank {r}")
    if row["live_inputs"] > 3:
        raise AssertionError(f"pipeline_1f1b_gang held {row['live_inputs']} "
                             f"stage inputs, more than 2P - 1 = 3")
    f = row["fp32"]
    if f["loss_rel"] > f["tol_loss"] or f["leaf_rel_max"] > f["tol_leaf"]:
        raise AssertionError(f"pipeline_1f1b_gang fp32: {f}")
    check_moe_aux(row["moe"], "pipeline_1f1b_gang MoE aux")


def phase_pipeline_1f1b_gang(one_row, kernel_names):
    """``train_1f1b`` on a gang: two processes on ``cuda:0`` joined over
    gloo, ``data=1 x pipeline=2`` each, the gang's ``data`` 2
    (:func:`pipeline_1f1b_gang_rank`, one subprocess pair), held by
    :func:`check_1f1b_gang` to ``pipeline_1f1b``'s one-process ``data=2
    x pipeline=2`` row ``one_row``. Two ranks on one card through host
    gloo: the ms is not a speed result. → the row."""
    import subprocess
    t_phase = time.perf_counter()
    port = _free_port()
    outdir = _scratch("pipeline-1f1b-gang-")
    outs = [f"{outdir}/rank{r}.json" for r in range(2)]
    procs = []
    for r in range(2):
        with open(f"{outdir}/rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--pipeline-1f1b-gang-rank",
                 str(r), str(port), outs[r]], stdout=log,
                stderr=subprocess.STDOUT, cwd=REPO))
    codes = _run_all(procs, PROCESS_TIMEOUT_S)
    if codes != [0, 0]:
        logs = [_tail(f"{outdir}/rank{r}.log") for r in (0, 1)]
        raise AssertionError(f"pipeline_1f1b_gang ranks exited {codes}: "
                             f"{logs}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    row = {**gang_1f1b_row(ranks, one_row, kernel_names), "layers": 12,
           "seq": TRAIN_BATCH[1], "microbatches": F1B_MICRO,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    check_1f1b_gang(row, 12, F1B_MICRO)
    return row


GANG_STEPS, GANG_FAULT_AT = 5, 3
GANG_TIMEOUT_S = 240


def _gang(ckpt, log, fault=False):
    """Two ``python -m kubeflow_tpu_torch.cmd slice-worker`` processes of
    one gang on the card (``SLICE_WORKER_DEVICE`` unset: one card, two
    ranks → gloo, both on ``cuda:0``) → the processes."""
    import subprocess
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_WORKER_", "SLICE_WORKER_FAULT_"))}
    env.update(TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
    if fault:
        env.update(SLICE_WORKER_FAULT_AT_STEP=str(GANG_FAULT_AT),
                   SLICE_WORKER_FAULT_WORKER="1")
    procs = []
    for w in range(2):
        with open(f"{log}.w{w}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.cmd",
                 "slice-worker", "--ckpt-dir", ckpt, "--steps",
                 str(GANG_STEPS), "--ckpt-every", "2",
                 "--log", f"{log}.w{w}.jsonl"],
                env={**env, "TPU_WORKER_ID": str(w)},
                stdout=subprocess.DEVNULL, stderr=err, cwd=REPO))
    return procs


def _gang_events(log, w):
    with open(f"{log}.w{w}.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def _last_checkpoint(ckpt):
    import torch
    from kubeflow_tpu_torch.compute import train
    step = max(int(n) for n in os.listdir(ckpt) if n.isdigit())
    saved = torch.load(os.path.join(ckpt, str(step), "state.pt"),
                       weights_only=True)
    return step, [t for t in train.tree_leaves(
        [saved["params"], saved["opt_state"]]) if hasattr(t, "shape")]


def phase_slice_worker():
    """The ``slice-worker`` entry as a gang of 2 on ``cuda:0``: a run
    with ``SLICE_WORKER_FAULT_AT_STEP=3`` on worker 1 (exit 17 and its
    ``fault-injected`` line; worker 0, waiting in the step's
    ``all_reduce``, is killed, as the TpuSlice controller restarts the
    whole gang), then the gang again: it resumes (``resumed`` true) from
    step 2, the last durable one, and finishes at 5; its last checkpoint
    equals an uninterrupted gang's (run beside the faulty one) within
    1e-6. Every process has a timeout; a hung rank fails the phase."""
    t_phase = time.perf_counter()
    root = _scratch("slice-worker-")
    clean = _gang(f"{root}/clean", f"{root}/clean")
    faulty = _gang(f"{root}/ckpt", f"{root}/run1", fault=True)
    try:
        fault_code = faulty[1].wait(timeout=GANG_TIMEOUT_S)
    finally:
        for p in faulty:       # the gang restart: every worker goes
            p.kill()
            p.wait()
    restarted = _gang(f"{root}/ckpt", f"{root}/run2", fault=True)
    codes = _run_all(restarted, GANG_TIMEOUT_S)
    clean_codes = _run_all(clean, GANG_TIMEOUT_S)
    if codes != [0, 0] or clean_codes != [0, 0]:
        errs = [_tail(f"{root}/{tag}.w{w}.err") for tag in ("run2", "clean")
                for w in (0, 1)]
        raise AssertionError(f"slice_worker gang exits {codes}, clean "
                             f"{clean_codes}: {errs}")
    run1 = [_gang_events(f"{root}/run1", w) for w in range(2)]
    run2 = [_gang_events(f"{root}/run2", w) for w in range(2)]
    step, got = _last_checkpoint(f"{root}/ckpt")
    clean_step, want = _last_checkpoint(f"{root}/clean")
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want))
    joined = run2[0][0]
    row = {"phase": "slice_worker", "processes": 2,
           "backend": joined.get("backend"), "device": joined.get("device"),
           "mesh": joined.get("mesh"), "fault_exit": fault_code,
           "fault_line": run1[1][-1],
           "resumed": [ev[0]["resumed"] for ev in run2],
           "start_step": [ev[0]["start_step"] for ev in run2],
           "done": [ev[-1] for ev in run2],
           "losses": [e["loss"] for e in run2[0] if e["event"] == "step"],
           "last_step": [step, clean_step],
           "checkpoint_max_abs_vs_clean": worst, "tol": 1e-6,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    if fault_code != 17 or run1[1][-1]["event"] != "fault-injected":
        raise AssertionError(f"slice_worker fault: exit {fault_code}, "
                             f"last line {run1[1][-1]}")
    if row["resumed"] != [True, True] or row["start_step"] != [2, 2]:
        raise AssertionError(f"slice_worker restart did not resume from "
                             f"step 2: {row['resumed']}, "
                             f"{row['start_step']}")
    if [d["event"] for d in row["done"]] != ["done", "done"] \
            or step != clean_step != GANG_STEPS:
        raise AssertionError(f"slice_worker did not finish: {row['done']}, "
                             f"steps {step}, {clean_step}")
    if worst > 1e-6:
        raise AssertionError(f"slice_worker restarted checkpoint leaves the "
                             f"uninterrupted one by {worst}")
    return row


SWEEP_TRIALS = [{"lr": lr, "hidden": hidden}
                for hidden in (64, 128) for lr in (1e-2, 3e-3, 1e-3, 3e-4)]


def phase_sweep():
    """The vectorized sweep on the card: 8 mnist trials in 2 shape
    buckets (hidden 64 and 128, four learning rates each), 30 steps,
    against 8 calls of ``run_mnist_trial``: objectives equal within
    1e-5; wall seconds of both."""
    import contextlib
    import io
    import os
    import torch
    from kubeflow_tpu_torch.compute import sweep, trial
    from kubeflow_tpu_torch.compute.ops import _build
    # a lone trial's final report also writes this file: keep it in build/
    os.environ["METRICS_PATH"] = str(_build.BUILD_DIR / "trial-metrics.json")
    sweep.run_mnist_sweep(SWEEP_TRIALS[:1], steps=2)      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = sweep.run_mnist_sweep(SWEEP_TRIALS, steps=30)
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lone = []
    with contextlib.redirect_stdout(io.StringIO()) as lines:
        for hp in SWEEP_TRIALS:
            lone.append(trial.run_mnist_trial(hp, steps=30))
    trials_s = time.perf_counter() - t0
    reported = [trial.parse_metric_line(ln)
                for ln in lines.getvalue().splitlines()]
    errs = [abs(r["objective"] - ref) for r, ref in zip(results, lone)]
    row = {"phase": "sweep", "trials": len(SWEEP_TRIALS), "buckets": 2,
           "steps": 30, "objectives": [r["objective"] for r in results],
           "lone_trials": lone, "max_abs_diff": max(errs), "tol": 1e-5,
           "sweep_s": sweep_s, "lone_trials_s": trials_s,
           "trials_per_hour_sweep": 3600 * len(SWEEP_TRIALS) / sweep_s,
           "trials_per_hour_lone": 3600 * len(SWEEP_TRIALS) / trials_s}
    emit(row)
    if [r["index"] for r in results] != list(range(len(SWEEP_TRIALS))):
        raise AssertionError("the sweep's results are out of order")
    if not all(np.isfinite(lone)) or max(errs) > 1e-5:
        raise AssertionError(f"the vectorized sweep leaves the lone trials: "
                             f"{errs}")
    if [p and p["value"] for p in reported] != lone:
        raise AssertionError("a lone trial's metric line does not carry its "
                             "objective")
    return row


class Int8Launches:
    """A pool read's int8 launch count (``fn.launches_i8``) as the
    ``.launches`` every entry of ``kernel_fns`` has."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_i8

    @launches.setter
    def launches(self, n):
        self.fn.launches_i8 = n


def counted_kernels():
    """Every kernel's wrapper by name → the object whose ``.launches``
    counts its launches (the int8 reads through ``Int8Launches``)."""
    from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
    from kubeflow_tpu_torch.compute.ops import fused_block as block_ops
    from kubeflow_tpu_torch.compute.ops import grouped_matmul as gmm_ops
    from kubeflow_tpu_torch.compute.ops import paged_attention as paged_ops
    return {"paged_decode": paged_ops.paged_decode_attention,
            "paged_chunk": paged_ops.paged_chunk_attention,
            "paged_decode_i8": Int8Launches(
                paged_ops.paged_decode_attention),
            "paged_chunk_i8": Int8Launches(paged_ops.paged_chunk_attention),
            "flash_fwd": flash_ops.flash_attention,
            "flash_bwd_dq": flash_ops.flash_attention_bwd_dq,
            "flash_bwd_dkv": flash_ops.flash_attention_bwd_dkv,
            "grouped_matmul": gmm_ops.grouped_matmul,
            "grouped_matmul_dw": gmm_ops.grouped_matmul_dw,
            "fused_block": block_ops.fused_bottleneck_eval}


def main():
    import torch
    from kubeflow_tpu_torch.compute.models import transformer
    if sys.argv[1:2] == ["--process-mesh-rank"]:   # a rank of process_mesh
        process_mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if sys.argv[1:2] == ["--pipeline-1f1b-gang-rank"]:
        pipeline_1f1b_gang_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    t_start = time.perf_counter()
    info = phase_device()
    ptxas = phase_build()
    if sys.argv[1:2] == ["--k8-bands"]:        # the side measurement only
        k8_band_sweep([int(b) for b in sys.argv[2].split(",")])
        print(info["card"], flush=True)
        return
    rows = phase_kernels(ptxas)
    params = transformer.init_params(
        flagship_config(), torch.Generator().manual_seed(0), device="cuda")
    kernel_fns = counted_kernels()
    paths = {"engine": phase_engine(params, kernel_fns)}
    paths["engine_i8"] = phase_engine_i8(params, kernel_fns, paths["engine"])
    paths["prefix"] = phase_prefix(params, kernel_fns)
    paths["prefix_i8"] = phase_prefix(params, kernel_fns, kv_dtype="int8")
    target, draft, dcfg = spec_pair(params, flagship_config())
    paths["speculative"] = phase_spec(target, draft, dcfg, kernel_fns)
    phase_conformance(params)
    phase_identity(params, target, draft, dcfg)
    wire = phase_wire(params, kernel_fns)
    paths["wire"], paths["wire_async"] = wire["threaded"], wire["async"]
    phase_wire_cmd()
    paths["qos"] = phase_qos(params, kernel_fns)
    paths["qos_i8"] = phase_qos_i8(params, kernel_fns, paths["qos"])
    paths["disagg"] = phase_disagg(params, kernel_fns)
    paths["disagg_i8"] = phase_disagg_i8(params, kernel_fns, paths["disagg"])
    hops = phase_disagg_wire(params, kernel_fns)
    paths["disagg_wire"] = hops["threaded"]
    paths["disagg_wire_async"] = hops["async"]
    predict = phase_predict(kernel_fns)
    paths["predict"], paths["predict_async"] = (predict["threaded"],
                                                predict["async"])
    phase_predict_residency()
    phase_predict_cmd()
    paths["mesh"] = phase_mesh(params, kernel_fns)
    del params, target, draft
    torch.cuda.empty_cache()
    paths["train"] = phase_train(kernel_fns)
    phase_train_conformance(kernel_fns)
    torch.cuda.empty_cache()
    paths["moe_apply"], paths["moe_train"] = phase_moe(kernel_fns)
    torch.cuda.empty_cache()
    phase_moe_conformance(kernel_fns)
    torch.cuda.empty_cache()
    paths["resnet_eval"] = phase_resnet_eval(kernel_fns)
    torch.cuda.empty_cache()
    paths["resnet_train"] = phase_resnet_train(kernel_fns)
    torch.cuda.empty_cache()
    paths["bert_train"] = phase_bert_train(kernel_fns)
    torch.cuda.empty_cache()
    phase_bert_conformance(kernel_fns)
    torch.cuda.empty_cache()
    paths["train_mesh"] = phase_train_mesh(kernel_fns, paths["train"])
    torch.cuda.empty_cache()
    phase_train_mesh_conformance(kernel_fns)
    torch.cuda.empty_cache()
    paths["bert_mesh"] = phase_bert_mesh(kernel_fns, paths["bert_train"])
    torch.cuda.empty_cache()
    paths["resnet_mesh"] = phase_resnet_mesh(kernel_fns,
                                             paths["resnet_train"])
    torch.cuda.empty_cache()
    paths["ring_mesh"] = phase_ring_mesh(kernel_fns)
    phase_ring_conformance(kernel_fns)
    torch.cuda.empty_cache()
    paths["bert_ring"] = phase_bert_ring(kernel_fns, paths["bert_train"])
    torch.cuda.empty_cache()
    paths["pipeline_mesh"] = phase_pipeline_mesh(kernel_fns, paths["train"])
    torch.cuda.empty_cache()
    phase_pipeline_conformance(kernel_fns)
    torch.cuda.empty_cache()
    paths["pipeline_1f1b"] = phase_pipeline_1f1b(kernel_fns)
    paths["pipeline_1f1b_data"] = paths["pipeline_1f1b"]["data"]
    torch.cuda.empty_cache()
    paths["pipeline_1f1b_moe"] = phase_pipeline_1f1b_moe(kernel_fns)
    torch.cuda.empty_cache()
    paths["pipeline_1f1b_gang"] = phase_pipeline_1f1b_gang(
        paths["pipeline_1f1b_data"], list(kernel_fns))
    torch.cuda.empty_cache()
    paths["moe_mesh"] = phase_moe_mesh(kernel_fns, paths["moe_train"])
    torch.cuda.empty_cache()
    phase_moe_mesh_conformance(kernel_fns)
    torch.cuda.empty_cache()
    paths["process_mesh"] = phase_process_mesh(
        {"flagship": paths["train"], "bert": paths["bert_train"],
         "resnet": paths["resnet_train"]}, list(kernel_fns))
    phase_slice_worker()
    phase_sweep()
    meta = {
        "paged_decode": (
            "kubeflow_tpu_torch/compute/ops/csrc/paged_decode.cu",
            "kubeflow_tpu/compute/ops/paged_attention.py:49"),
        "flash_fwd": (
            "kubeflow_tpu_torch/compute/ops/csrc/flash_fwd.cu",
            "kubeflow_tpu/compute/ops/flash_attention.py:36"),
        "paged_chunk": (
            "kubeflow_tpu_torch/compute/ops/csrc/paged_chunk.cu",
            "kubeflow_tpu/compute/ops/paged_attention.py:190"),
        "paged_decode_i8": (     # the int8_pages branch of _decode_kernel
            "kubeflow_tpu_torch/compute/ops/csrc/paged_decode.cu",
            "kubeflow_tpu/compute/ops/paged_attention.py:75"),
        "paged_chunk_i8": (      # the int8_pages branch of _chunk_kernel
            "kubeflow_tpu_torch/compute/ops/csrc/paged_chunk.cu",
            "kubeflow_tpu/compute/ops/paged_attention.py:236"),
        "flash_bwd_dq": (
            "kubeflow_tpu_torch/compute/ops/csrc/flash_bwd.cu",
            "kubeflow_tpu/compute/ops/flash_attention.py:83"),
        "flash_bwd_dkv": (
            "kubeflow_tpu_torch/compute/ops/csrc/flash_bwd.cu",
            "kubeflow_tpu/compute/ops/flash_attention.py:127"),
        "grouped_matmul": (
            "kubeflow_tpu_torch/compute/ops/csrc/grouped_matmul.cu",
            "kubeflow_tpu/compute/ops/grouped_matmul.py:44"),
        "grouped_matmul_dw": (
            "kubeflow_tpu_torch/compute/ops/csrc/grouped_matmul.cu",
            "kubeflow_tpu/compute/ops/grouped_matmul.py:116"),
        "fused_block": (
            "kubeflow_tpu_torch/compute/ops/csrc/fused_block.cu",
            "kubeflow_tpu/compute/ops/fused_block.py:68"),
    }

    def attn_at(r, shape):
        return (r["shape"]["seq"] == shape["S"]
                and r["shape"]["batch"] == shape["B"]
                and r["shape"]["kv_heads"] == shape["kv"])

    def bf16(r):
        return r["dtype"] == "bfloat16"

    serving_attn = dict(S=1024, B=1, kv=2)
    main_shape = {
        "paged_decode": bf16,
        "flash_fwd": lambda r: bf16(r) and attn_at(r, serving_attn),
        "paged_chunk": lambda r: (bf16(r)
                                  and r["shape"]["site"] == "prefill_chunk"),
        "paged_decode_i8": bf16,
        "paged_chunk_i8": lambda r: (bf16(r) and r["shape"]["site"]
                                     == "prefill_chunk"),
        "flash_bwd_dq": lambda r: bf16(r) and attn_at(r, TRAIN_ATTN),
        "flash_bwd_dkv": lambda r: bf16(r) and attn_at(r, TRAIN_ATTN),
        "grouped_matmul": lambda r: bf16(r) and r["shape"]["site"]
        == "gate_up",
        "grouped_matmul_dw": lambda r: bf16(r) and r["shape"]["site"]
        == "dw_gate_up",
        "fused_block": lambda r: bf16(r) and r["shape"]["height"] == 56}
    timing_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "shape")
    rows = [r for r in rows if not r.get("side_row")]
    kernels = []
    for name, (source, replaces) in meta.items():
        r = next(r for r in rows
                 if r["kernel"] == name and main_shape[name](r))
        by_path = {p: row["launches"][name] for p, row in paths.items()}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == name
                               and x["dtype"] == "bfloat16"),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": r["dtype"],
            "shape": r["shape"]}
        flash_keys = timing_keys + ("tflops",)
        if name == "flash_fwd":      # also at the train step's shape
            t = next(x for x in rows if x["kernel"] == name
                     and bf16(x) and attn_at(x, TRAIN_ATTN))
            entry["at_train_shape"] = {k: t[k] for k in flash_keys}
        if name.startswith("flash"):  # at the MoE step's (MHA), BERT's
            entry["tflops"] = r["tflops"]
            for key, shape in (("at_moe_shape", MOE_ATTN),
                               ("at_bert_shape", BERT_ATTN)):
                t = next(x for x in rows if x["kernel"] == name
                         and bf16(x) and attn_at(x, shape))
                entry[key] = {k: t[k] for k in flash_keys}
        if name == "fused_block":     # every ResNet-50 stage
            entry["library"] = r["library"]
            entry["stages"] = {
                f"{x['shape']['height']}x{x['shape']['width']}x"
                f"{x['shape']['channels']}": {
                    k: x[k] for k in timing_keys + ("library", "tflops")}
                for x in rows if x["kernel"] == name and bf16(x)}
        if name.startswith("flash_bwd"):
            entry["library_covers"] = r["library_covers"]
            entry["plain_covers"] = r["plain_covers"]
        if name.endswith("_i8"):      # beside the float kernel's time
            entry["float_kernel_ms"] = r["float_kernel_ms"]
        if name.startswith("paged_chunk"):   # every call site
            entry["sites"] = {x["shape"]["site"]: {
                k: x[k] for k in timing_keys + ("float_kernel_ms",)
                if k in x}
                for x in rows if x["kernel"] == name and bf16(x)}
        if name.startswith("grouped"):
            entry["library"] = r["library"]
            entry["sites"] = {x["shape"]["site"]: {
                k: x[k] for k in timing_keys + ("library", "tflops")}
                for x in rows if x["kernel"] == name and bf16(x)}
        kernels.append(entry)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(info["card"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
