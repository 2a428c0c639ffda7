"""K1, K2 and K3 with the key window off, the parent's build against this
tree's, at ``mistral-7b.docqa``'s shapes, timed in one process.

    python3 hack/window_off_ab.py parent=archive_check/parent change=.

Each ``label=path`` names a checkout (a parent commit: ``git archive
<commit> | tar -x -C archive_check/parent``, a git-ignored directory).
Its ``paged_decode.cu``, ``paged_chunk.cu`` and ``flash_fwd.cu`` are
compiled with the port's ``nvcc`` flags into ``build/window_off_ab/
<label>/`` and their entry points with the window off
(``kubeflow_paged_decode``, ``kubeflow_paged_chunk``,
``kubeflow_flash_fwd`` in a tree without windows, their ``_window``
forms at window 0 in one with them: ``hack/ab_entry.py``) are called
on one set of bf16 tensors: K1 over 128 slots of
1024–3584 positions (8 kv heads × GQA 4, block 16, a 256-block
table), K2 over a prefix hit's 64-token question behind 2048 cached
positions, K3 over a 2048-token prompt (32 heads, 8 kv heads, causal).
Prints the card and its power limit, then one JSON line a kernel: the
ms of each tree in turns (first to last, then last to first, 20 calls
each, CUDA events), and whether every tree's output equals the first
tree's bit for bit. Needs a CUDA device.
"""

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import ab_entry  # noqa: E402
from kubeflow_tpu_torch.compute.ops import _build  # noqa: E402
from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops  # noqa: E402
from kubeflow_tpu_torch.compute.ops import paged_attention as ops  # noqa: E402

CSRC = pathlib.Path("kubeflow_tpu_torch/compute/ops/csrc")
KV, REP, D, BS, BPS = 8, 4, 128, 16, 256
V, I = ctypes.c_void_p, ctypes.c_int


def build(label, tree):
    """The tree's three libraries → their window-off entry points."""
    out = ROOT / "build" / "window_off_ab" / label
    out.mkdir(parents=True, exist_ok=True)
    fns = {}
    for src, sym, args in (
            ("paged_decode", "kubeflow_paged_decode", [V] * 7 + [I] * 8),
            ("paged_chunk", "kubeflow_paged_chunk", [V] * 9 + [I] * 9),
            ("flash_fwd", "kubeflow_flash_fwd", [V] * 5 + [I] * 8)):
        lib = out / f"lib{src}.so"
        proc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(pathlib.Path(tree) / CSRC / f"{src}.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{label} {src}: {proc.stderr}")
        fns[src] = ab_entry.entry(ctypes.CDLL(str(lib)), sym, args + [V])
    return fns


def cases():
    """``{kernel: (inputs kept alive, output, call(fn))}``."""
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    S = 128
    lens = torch.linspace(1024, 3584, S).round().to(torch.int32).cuda()
    pages = [torch.randn((S * BPS, BS, KV, D), generator=g).to("cuda", bf)
             for _ in range(2)]
    tables = torch.randperm(S * BPS, generator=g).reshape(S, BPS).to(
        "cuda", torch.int32)
    q1 = flash_ops._prescale(torch.randn((S, 1, KV * REP, D), generator=g)
                             .to("cuda", bf), None).contiguous()
    splits = ops.decode_splits(S, KV, BS, BPS, ops._sm_count(0))
    ws1 = torch.empty(splits * S * KV * REP * (D + 2), device="cuda")
    o1 = torch.empty_like(q1)
    k1 = (lambda fn: fn(q1.data_ptr(), pages[0].data_ptr(),
                        pages[1].data_ptr(), tables.data_ptr(),
                        lens.data_ptr(), o1.data_ptr(), ws1.data_ptr(), S,
                        KV, REP, D, BS, BPS, splits, 1, stream))
    B, Sc = 1, 64
    q2 = flash_ops._prescale(torch.randn((B, Sc, KV * REP, D), generator=g)
                             .to("cuda", bf), None).contiguous()
    kc = torch.randn((B, Sc, KV, D), generator=g).to("cuda", bf)
    vc = torch.randn((B, Sc, KV, D), generator=g).to("cuda", bf)
    plen = torch.tensor([2048], dtype=torch.int32, device="cuda")
    csplits = ops.chunk_splits(B, Sc, KV, REP, BS, BPS, ops._sm_count(0))
    ws2 = torch.empty(csplits * B * Sc * KV * REP * (D + 2), device="cuda")
    o2 = torch.empty_like(q2)
    t2 = tables[:1].contiguous()
    k2 = (lambda fn: fn(q2.data_ptr(), pages[0].data_ptr(),
                        pages[1].data_ptr(), t2.data_ptr(), plen.data_ptr(),
                        kc.data_ptr(), vc.data_ptr(), o2.data_ptr(),
                        ws2.data_ptr(), B, Sc, KV, REP, D, BS, BPS, csplits,
                        1, stream))
    Sp = 2048
    q3 = flash_ops._prescale(torch.randn((1, Sp, KV * REP, D), generator=g)
                             .to("cuda", bf), None).contiguous()
    k3_ = torch.randn((1, Sp, KV, D), generator=g).to("cuda", bf)
    v3 = torch.randn((1, Sp, KV, D), generator=g).to("cuda", bf)
    o3 = torch.empty_like(q3)
    lse = torch.empty((1, KV * REP, Sp), device="cuda")
    k3 = (lambda fn: fn(q3.data_ptr(), k3_.data_ptr(), v3.data_ptr(),
                        o3.data_ptr(), lse.data_ptr(), 1, Sp, Sp, KV * REP,
                        KV, D, 1, 1, stream))
    keep = (lens, pages, tables, q1, ws1, q2, kc, vc, plen, ws2, t2, q3,
            k3_, v3, lse)
    return keep, {"paged_decode": (o1, k1), "paged_chunk": (o2, k2),
                  "flash_fwd": (o3, k3)}


def time_ms(call, n=20):
    call()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main(argv):
    trees = dict(a.split("=", 1) for a in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = {label: build(label, tree) for label, tree in trees.items()}
    keep, kernels = cases()
    for name, (out, call) in kernels.items():
        outs = {}
        for label, fns in built.items():
            out.zero_()
            assert call(fns[name]) == 0
            torch.cuda.synchronize()
            outs[label] = out.clone()
        first = next(iter(outs.values()))
        row = {"kernel": name, "bit_identical": all(
            torch.equal(first, o) for o in outs.values())}
        order = list(built) + list(reversed(built))
        for turn, label in enumerate(order):
            row[f"{label} ms {turn}"] = time_ms(lambda: call(
                built[label][name]))
        print(json.dumps(row), flush=True)
    del keep


if __name__ == "__main__":
    main(sys.argv[1:])
