"""K8 (the fused identity bottleneck) from several source trees, timed in
one process.

    python3 hack/block_ab.py parent=build/parent change=.

Each ``label=path`` names a checkout of this repository (for a parent
commit: ``git archive <commit> | tar -x -C build/parent``, a git-ignored
directory). Its ``csrc/fused_block.cu`` is compiled with the port's
``nvcc`` flags into ``build/block_ab/<label>/`` and the C entry point
``kubeflow_fused_block`` is called directly, on one set of folded
operands per stage: no wrapper, so no BN folding and no allocation in
the time. At the identity block of each ResNet-50 stage
(``chip_smoke.BLOCK_SHAPES``: 56x56x256, 28x28x512, 14x14x1024,
7x7x2048, bottleneck C/4, batch 256, BN randomised) every tree runs in
bf16 in turns, first to last then last to first, and in fp32 once; each
call timed by ``chip_smoke.time_ms`` (L2 flushed before every call).

Prints the card's name and power limit, each build's registers and
spills per kernel (from ``nvcc -Xptxas -v``), then one JSON line per
stage and dtype: per tree the band, threads and (where the tree's
library reports it) block tile and step depth of its plan, the ms of
each turn, the useful TFLOP/s (2 px (2CM + 9M^2) over the best turn),
the weight bytes its blocks pull from L2 per ms (``chip_smoke.
k8_weight_bytes``; a tree without ``kubeflow_fused_block_tiles`` is
taken as the earlier wmma kernel: 16 warps of 32 x 32 unless the padded
image fits 8, halo rows always computed), and the largest error against the
plain PyTorch version (``matmul_chain_reference``), absolute and of its
max |value|. Needs a CUDA device.
"""

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from kubeflow_tpu_torch.compute.ops import _build  # noqa: E402
from kubeflow_tpu_torch.compute.ops import fused_block as ops  # noqa: E402

CSRC = pathlib.Path("kubeflow_tpu_torch/compute/ops/csrc")
DTYPES = {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}


def compile_all(trees):
    """One ``nvcc`` per tree, all started together → {label: library}."""
    jobs = {}
    for label, tree in trees.items():
        src = pathlib.Path(tree) / CSRC / "fused_block.cu"
        out_dir = ROOT / "build" / "block_ab" / label
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / "libfused_block.so"
        jobs[label] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return {label: load(label, lib, proc)
            for label, (lib, proc) in jobs.items()}


def load(label, lib, proc):
    """A finished build → its ctypes library, its ptxas lines printed."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{log}")
    for kernel, e in chip_smoke.ptxas_entries(log).items():
        print(json.dumps({"tree": label, "kernel": kernel,
                          **{k: e[k] for k in ("registers", "spill_stores",
                                               "spill_loads")}}),
              flush=True)
    cdll = ctypes.CDLL(str(lib))
    if hasattr(cdll, "kubeflow_fused_block_tiles"):
        return ops.bind(cdll)
    # an older tree: the plan and the launch only
    cdll.kubeflow_fused_block.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    cdll.kubeflow_fused_block.restype = ctypes.c_int
    cdll.kubeflow_fused_block_plan.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    cdll.kubeflow_fused_block_plan.restype = ctypes.c_int
    return cdll


def plan(lib, h, w, c, m, code):
    """The tree's plan at this shape: band, shared memory, threads and,
    where its library reports them, the block tile and step depth."""
    p = (ctypes.c_int * 3)()
    if lib.kubeflow_fused_block_plan(h, w, c, m, 0, code, p):
        raise RuntimeError(f"no plan for {h}x{w}x{c}/{m}")
    out = {"band_rows": p[0], "shared_memory_bytes": p[1],
           "block_threads": p[2]}
    if hasattr(lib, "kubeflow_fused_block_tiles"):
        t = (ctypes.c_int * 3)()
        lib.kubeflow_fused_block_tiles(h, w, c, m, 0, code, t)
        out.update(zip(("block_m", "block_n", "depth"), t))
    else:                    # the earlier wmma kernel: 32 values a thread
        bn = 64 if m < 128 else 128
        out["block_m"] = 32 * p[2] // bn
    return out


def measure(libs, flush, shape, dtype_name):
    hw, c = shape
    m = c // 4
    n = chip_smoke.BLOCK_BATCH
    dtype, code = DTYPES[dtype_name]
    g = torch.Generator().manual_seed(hw * 7 + c)
    bp, bs = chip_smoke.random_block(c, m, g)
    x = torch.randn((n, hw, hw, c), generator=g).to("cuda", dtype)
    operands = ops.folded_operands(bp, bs, dtype)
    want = ops.matmul_chain_reference(x, *operands).float()
    scale = float(want.abs().max())
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (x, *operands, out)]
    flops = 2 * n * hw * hw * (2 * c * m + 9 * m * m)
    row = {"height": hw, "width": hw, "channels": c, "bottleneck": m,
           "batch": n, "dtype": dtype_name}
    labels = list(libs)
    turns = (labels, labels[::-1]) if dtype_name == "bfloat16" else (labels,)
    for turn, order in enumerate(turns):
        for label in order:
            lib = libs[label]
            call = lambda: lib.kubeflow_fused_block(  # noqa: E731
                *ptrs, n, hw, hw, c, m, 0, code, stream)
            out.zero_()
            if call():
                raise RuntimeError(f"{label} {shape}: launch failed")
            torch.cuda.synchronize()
            ms = chip_smoke.time_ms(call, flush, iters=10)
            row.setdefault(f"{label} ms", []).append(ms)
            if turn == 0:
                p = plan(lib, hw, hw, c, m, code)
                row[f"{label} plan"] = p
                err = float((out.float() - want).abs().max())
                row[f"{label} max_abs_err"] = err
                row[f"{label} max_rel_err"] = err / scale
                row[f"{label} l2_weight_bytes"] = chip_smoke.k8_weight_bytes(
                    n, hw, hw, c, m, p["band_rows"], p["block_m"],
                    x.element_size(), halo_inside="depth" in p,
                    row_align=16 if code else 1)
    for label in labels:
        best = min(row[f"{label} ms"])
        row[f"{label} tflops"] = flops / best / 1e9
        row[f"{label} l2_weight_bytes_per_ms"] = (
            row[f"{label} l2_weight_bytes"] / best)
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    trees = dict(a.split("=", 1) for a in sys.argv[1:])
    if not trees:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = compile_all(trees)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for dtype_name in ("bfloat16", "float32"):
        for shape in chip_smoke.BLOCK_SHAPES:
            measure(libs, flush, shape, dtype_name)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
