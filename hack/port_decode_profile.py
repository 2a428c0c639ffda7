"""Where the PyTorch port's serving steps spend their time on one GPU.

    python3 hack/port_decode_profile.py [--context 512] [--steps 20]
                                        [--kv-dtype int8]

Builds the bench-LM flagship engine of ``chip_smoke.py`` (bf16, 8
slots, block 16, random weights from a seed; layers 2.. dampened and
the first 2 as the speculative draft, ``spec_k=4``, as in its
speculative phase; ``--kv-dtype int8``: on an int8 KV pool, read by
K1-i8 and K2-i8) and drives its device steps directly from this
thread:

- the plain decode step, eagerly (its launches, not the engine's graph
  replay), with all 8 slots active at ``--context`` cached positions
  each;
- the prefill step of one 300-token prompt;
- one 256-token prefill chunk behind 768 cached positions (the chunk
  read, K2, with a scalar prefix);
- a prefix hit's 64-token suffix behind 512 cached positions (K2);
- the draft's proposal of 4 tokens for 8 slots, then the target's
  verify of 5 positions per slot at ``--context`` (K2 with per-slot
  prefixes).

For each it prints one JSON line: the host wall time per step (each
step ends in a device sync), the device time per step (the sum of the
CUDA kernels torch.profiler saw) and the share of the wall the device
sat idle, then the device time by kernel group
(``profiler.KERNEL_GROUPS``), the kernels and the CPU-side ops that
take the most time. The card's name and power limit come first. Needs a CUDA device.
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import flagship_config, spec_pair  # noqa: E402
from kubeflow_tpu_torch.compute import device as device_lib  # noqa: E402
from kubeflow_tpu_torch.compute import generate as gen_lib  # noqa: E402
from kubeflow_tpu_torch.compute import profiler  # noqa: E402
from kubeflow_tpu_torch.compute.models import transformer  # noqa: E402


def profile(step, n, top=12):
    """Host ms per call of ``step`` over ``n`` calls, then a profiled
    run of ``n`` more: device ms per call, idle share, top kernels and
    top CPU ops (ms per call)."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    cpu = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    cpu.sort(key=lambda e: -e.self_cpu_time_total)
    return {
        **profiler.device_summary(prof, wall_ms, steps=n, top=top),
        "top_cpu_ops": [
            {"name": e.key[:90], "calls": e.count / n,
             "self_ms": e.self_cpu_time_total / 1e3 / n}
            for e in cpu[:top]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-dtype", choices=("int8",), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(device_lib.card_identity(), flush=True)
    cfg = flagship_config()
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(args.seed), device="cuda")
    target, draft, dcfg = spec_pair(params, cfg)
    K = 4
    eng = gen_lib.GenerationEngine(target, cfg, max_slots=8, block_size=16,
                                   max_context=1024, draft_params=draft,
                                   draft_config=dcfg, spec_k=K,
                                   kv_dtype=args.kv_dtype, name="profile")
    try:
        rng = np.random.default_rng(args.seed)
        S, bs, bps = eng.max_slots, eng.block_size, eng.blocks_per_slot
        ctx = args.context
        per_slot = -(-(ctx + K + 1) // bs)
        blocks = rng.permutation(eng.num_blocks)[:S * per_slot].reshape(
            S, per_slot)
        tables = np.zeros((S, bps), np.int32)
        tables[:, :per_slot] = blocks
        lengths = np.full((S,), ctx, np.int32)
        tokens = rng.integers(0, cfg.vocab_size, S).astype(np.int64)
        step_in = eng._blank_step(np.empty_like(eng._step_np))
        s_tables, s_lengths, s_tokens, phys, off, live = \
            eng._step_views(step_in)
        s_tables[:], s_lengths[:], s_tokens[:] = tables, lengths, tokens
        phys[:], off[:], live[:] = blocks[:, ctx // bs], ctx % bs, 1
        step_in = eng._put(step_in)
        with torch.no_grad():
            decode = profile(lambda: eng._decode_step(step_in), args.steps)
            prompt = np.zeros((300,), np.int64)
            prompt[:] = rng.integers(0, cfg.vocab_size, 300)
            fresh = list(range(-(-300 // bs)))
            prefill = profile(lambda: eng._prefill_step(prompt, 300, fresh),
                              max(3, args.steps // 4))
            order = rng.permutation(eng.num_blocks).tolist()
            chunk_toks = rng.integers(0, cfg.vocab_size, 256).astype(np.int64)
            chunk = profile(lambda: eng._prefill_cached_step(
                chunk_toks, 256, 768, order[:48], order[48:64]),
                max(3, args.steps // 4))
            hit = profile(lambda: eng._prefill_cached_step(
                chunk_toks[:64], 64, 512, order[:32], order[64:68]),
                max(3, args.steps // 4))
            limits = (lengths + K).astype(np.int64)
            propose = profile(lambda: eng._propose_step(tokens, lengths,
                                                        limits), args.steps)
            vtokens = np.concatenate(
                [tokens[:, None],
                 rng.integers(0, cfg.vocab_size, (S, K))], axis=1)
            pos = ctx + np.arange(K + 1)
            vwrites = np.stack([
                np.repeat(np.arange(S), K + 1), np.tile(np.arange(K + 1), S),
                blocks[:, pos // bs].reshape(-1),
                np.tile(pos % bs, S)]).astype(np.int64)
            verify = profile(lambda: eng._verify_step(tables, lengths,
                                                      vtokens, vwrites),
                             args.steps)
    finally:
        eng.close()
    pool = {"kv_dtype": eng.snapshot()["kv_dtype"]}
    print(json.dumps({"step": "decode", "slots": S, "context": ctx, **pool,
                      **decode}), flush=True)
    print(json.dumps({"step": "prefill", "prompt": 300, **pool, **prefill}),
          flush=True)
    print(json.dumps({"step": "prefill_chunk", "chunk": 256, "prefix": 768,
                      **pool, **chunk}), flush=True)
    print(json.dumps({"step": "prefix_hit", "suffix": 64, "prefix": 512,
                      **pool, **hit}), flush=True)
    print(json.dumps({"step": "propose", "slots": S, "spec_k": K,
                      "draft_layers": dcfg.n_layers, **pool, **propose}),
          flush=True)
    print(json.dumps({"step": "verify", "slots": S, "rows": K + 1,
                      "context": ctx, **pool, **verify}), flush=True)


if __name__ == "__main__":
    main()
