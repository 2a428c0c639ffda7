"""K2 and K2-i8 in bf16 from several source trees, timed in one process.

    python3 hack/chunk_ab.py parent=build/parent change=.

Each ``label=path`` names a checkout of this repository (for a parent
commit: ``git archive <commit> | tar -x -C build/parent``, a git-ignored
directory). Its ``csrc/paged_chunk.cu`` is compiled with the port's
``nvcc`` flags into ``build/chunk_ab/<label>/``, and the C entry points
``kubeflow_paged_chunk`` (K2) and ``kubeflow_paged_chunk_i8`` (K2-i8)
are called directly on one set of tensors: no wrapper, so no prescale
pass and no allocation in the time. Two signatures are known: a tree
whose entry points take a workspace and a split count (the split key
walk) gets the split count of ``paged_attention.chunk_splits`` for this
card and a workspace allocated once; an older tree takes neither. At
each of ``chip_smoke.CHUNK_CASES`` (a 256-row prefill chunk behind 768
cached positions, a 64-row prefix hit behind 512, an 8-slot verify of 5
rows), float pages and the same draw quantized to int8, every tree runs
in turns, first to last then last to first, each call timed by
``chip_smoke.time_ms`` (L2 flushed before every call).

Prints the card's name and power limit, each build's registers and
spills per kernel (from ``nvcc -Xptxas -v``), then one JSON line per
site and page type: ms per tree and turn, the splits and blocks of each
tree's grid, and the largest absolute error against the plain PyTorch
version. Needs a CUDA device.
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
from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops  # noqa: E402
from kubeflow_tpu_torch.compute.ops import paged_attention as ops  # noqa: E402

CSRC = pathlib.Path("kubeflow_tpu_torch/compute/ops/csrc")
BF16 = 1   # the C interface's dtype code
KV, N_REP, D, BS, BPS = 2, 4, 128, 16, 64   # chip_smoke.check_chunk's


def build(label, tree):
    """Compile the tree's ``paged_chunk.cu`` → ``{"split": bool, "float":
    K2, "int8": K2-i8}``, its ctypes entry points."""
    src = pathlib.Path(tree) / CSRC / "paged_chunk.cu"
    split = "void* ws" in src.read_text()
    out_dir = ROOT / "build" / "chunk_ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libpaged_chunk.so"
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    for kernel, e in chip_smoke.ptxas_entries(
            proc.stdout + proc.stderr).items():
        print(json.dumps({"tree": label, "kernel": kernel,
                          **{k: e[k] for k in ("registers", "spill_stores",
                                               "spill_loads")}}),
              flush=True)
    cdll = ctypes.CDLL(str(lib))
    fns = {"split": split, "float": cdll.kubeflow_paged_chunk,
           "int8": cdll.kubeflow_paged_chunk_i8}
    extra = 1 if split else 0   # the workspace pointer, the split count
    fns["float"].argtypes = [ctypes.c_void_p] * (8 + extra) + [
        ctypes.c_int] * (8 + extra) + [ctypes.c_void_p]
    fns["int8"].argtypes = [ctypes.c_void_p] * (10 + extra) + [
        ctypes.c_int] * (8 + extra) + [ctypes.c_void_p]
    fns["float"].restype = fns["int8"].restype = ctypes.c_int
    return fns


def measure(trees, flush, case, int8):
    site, B, S, prefixes = case
    H = KV * N_REP
    g = torch.Generator().manual_seed(S)
    N = B * BPS
    kc, vc = (torch.randn((N, BS, KV, D), generator=g).to(
        "cuda", torch.bfloat16) for _ in range(2))
    q = torch.randn((B, S, H, D), generator=g).to("cuda", torch.bfloat16)
    kch, vch = (torch.randn((B, S, KV, D), generator=g).to(
        "cuda", torch.bfloat16) for _ in range(2))
    tables = torch.randperm(N, generator=g).reshape(B, BPS).to(
        "cuda", torch.int32)
    plen = torch.tensor(prefixes, dtype=torch.int32, device="cuda")
    pages = chip_smoke._int8_pool((kc, vc)) if int8 else (kc, vc)
    want = ops.paged_chunk_reference(q, pages, tables, plen, kch, vch,
                                     block_size=BS, n_rep=N_REP)
    qs = flash_ops._prescale(q, None).contiguous()
    out = torch.empty_like(qs)
    splits = ops.chunk_splits(B, S, KV, N_REP, BS, BPS,
                              torch.cuda.get_device_properties(
                                  0).multi_processor_count)
    ws = torch.empty(splits * B * S * H * (D + 2), dtype=torch.float32,
                     device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (qs, *pages, tables, plen, kch, vch, out)]
    row_tiles = -(-S // (ops.CHUNK_ROW_TILE // N_REP))
    row = {"site": site, "pages": "int8" if int8 else "bf16", "batch": B,
           "chunk": S, "prefix": prefixes}
    labels = list(trees)
    for turn, order in enumerate((labels, labels[::-1])):
        for label in order:
            t = trees[label]
            fn = t["int8" if int8 else "float"]
            if t["split"]:
                args = (*ptrs, ws.data_ptr(), B, S, KV, N_REP, D, BS, BPS,
                        splits, BF16, stream)
            else:
                args = (*ptrs, B, S, KV, N_REP, D, BS, BPS, BF16, stream)
            call = lambda: fn(*args)  # noqa: E731
            if call():
                raise RuntimeError(f"{label} {site}: launch failed")
            torch.cuda.synchronize()
            ms = chip_smoke.time_ms(call, flush)
            row.setdefault(f"{label} ms", []).append(ms)
            if turn == 0:
                n_split = splits if t["split"] else 1
                row[f"{label} splits"] = n_split
                row[f"{label} blocks"] = row_tiles * KV * B * n_split
                row[f"{label} max_abs_err"] = float(
                    (out.float() - want.float()).abs().max())
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
    built = {label: build(label, tree) for label, tree in trees.items()}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for int8 in (False, True):
        for case in chip_smoke.CHUNK_CASES:
            measure(built, flush, case, int8)


if __name__ == "__main__":
    main()
