"""K1 and K1-i8 from several source trees, timed in one process.

    python3 hack/decode_ab.py parent=build/parent change=. \
        [--splits 1,2,4,8,17,32]

Each ``label=path`` names a checkout of this repository (for a parent
commit: ``git archive <commit> | tar -x -C build/parent``, a git-ignored
directory). Its ``csrc/paged_decode.cu`` is compiled with the port's
``nvcc`` flags into ``build/decode_ab/<label>/``, and the C entry points
``kubeflow_paged_decode`` (K1) and ``kubeflow_paged_decode_i8`` (K1-i8)
are called directly on one set of tensors: no wrapper, so no prescale
pass and no allocation in the time. Two signatures are known: a tree
whose entry points take a workspace and a split count (the split key
walk) gets the split count of ``paged_attention.decode_splits`` for this
card and a workspace allocated once; an older tree takes neither (one
block a slot and kv head). At each of ``SHAPES`` (``chip_smoke.py``'s
eight ragged slots, the engine's decode step of 8 slots at 512
positions, one lone slot at 1024), bf16 and fp32, float pages and the
same draw quantized to int8, every tree runs in turns, first to last
then last to first, each call timed by ``chip_smoke.time_ms`` (L2
flushed before every call).

Prints the card's name and power limit, each build's registers and
spills per kernel (from ``nvcc -Xptxas -v``), then one JSON line per
shape, dtype and page type: ms per tree and turn, the splits and blocks
of each tree's grid, the ms with the L2 not flushed (the inputs
resident, as in a step that has just written them), the device µs of
each of the tree's kernels a call
(``torch.profiler``, L2 flushed before each call: the walk and the
combine apart), the largest absolute error against the plain PyTorch
version, SDPA's time over the gathered context and the least time the
card could take (``chip_smoke.decode_yardsticks``). With ``--splits``,
the last tree that splits its walk is also timed in bf16 at each shape
with the split count forced to each of those values (the walk's span
against the blocks' fixed cost), one line each. Needs a CUDA device.
"""

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import ab_entry  # noqa: E402
import chip_smoke  # noqa: E402
from kubeflow_tpu_torch.compute.ops import _build  # noqa: E402
from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops  # noqa: E402
from kubeflow_tpu_torch.compute.ops import paged_attention as ops  # noqa: E402

CSRC = pathlib.Path("kubeflow_tpu_torch/compute/ops/csrc")
DTYPES = {"bfloat16": 1, "float32": 0}   # the C interface's dtype codes
KV, N_REP, D, BS, BPS = 2, 4, 128, 16, 64   # chip_smoke._paged_case's
SHAPES = (("serving", chip_smoke.DECODE_LENGTHS),
          ("decode_8x512", [512] * 8),
          ("lone_1024", [1024]))


def build(label, tree):
    """Compile the tree's ``paged_decode.cu`` → ``{"split": bool,
    "float": K1, "int8": K1-i8}``, its ctypes entry points."""
    src = pathlib.Path(tree) / CSRC / "paged_decode.cu"
    split = "void* ws" in src.read_text()
    out_dir = ROOT / "build" / "decode_ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libpaged_decode.so"
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
    extra = 1 if split else 0   # the workspace pointer, the split count
    return {"split": split, **{
        kind: ab_entry.entry(cdll, name, [ctypes.c_void_p] * (n + extra)
                             + [ctypes.c_int] * (7 + extra)
                             + [ctypes.c_void_p])
        for kind, name, n in (("float", "kubeflow_paged_decode", 6),
                              ("int8", "kubeflow_paged_decode_i8", 8))}}


def kernel_us(call, flush, n=10):
    """Device µs a call by kernel (``torch.profiler``), the L2 flushed
    before each call."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        for _ in range(n):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        m = re.search(r"paged_decode\w*", e.key)
        if m:
            t = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
            us[m.group(0)] = us.get(m.group(0), 0.0) + t / n
    return us


def _inputs(shape, dtype_name, int8):
    """One draw at ``shape`` → the inputs, the plain version's output,
    the prescaled q and the output (which the C call's pointers name:
    keep them alive while it runs), the pointers."""
    name, lengths = shape
    dtype = getattr(torch, dtype_name)
    q, pages, tables, lens, _, _ = chip_smoke._paged_case(dtype,
                                                          lengths=lengths)
    if int8:
        pages = chip_smoke._int8_pool(pages)
    want = ops.paged_decode_reference(q, pages, tables, lens, block_size=BS,
                                      n_rep=N_REP)
    qs = flash_ops._prescale(q, None).contiguous()
    out = torch.empty_like(qs)
    ptrs = [t.data_ptr() for t in (qs, *pages, tables, lens, out)]
    return q, pages, tables, lens, want, qs, out, ptrs


def _split_args(ptrs, ws, S, splits, dtype_name):
    stream = torch.cuda.current_stream().cuda_stream
    return (*ptrs, ws.data_ptr(), S, KV, N_REP, D, BS, BPS, splits,
            DTYPES[dtype_name], stream)


def sweep(fns, flush, shape, splits_list):
    """The split tree in bf16 at ``shape`` with each forced split count."""
    for int8 in (False, True):
        q, pages, tables, lens, want, qs, out, ptrs = _inputs(
            shape, "bfloat16", int8)
        S, _, H, _ = q.shape
        fn = fns["int8" if int8 else "float"]
        for splits in splits_list:
            ws = torch.empty(splits * S * H * (D + 2), dtype=torch.float32,
                             device="cuda")
            args = _split_args(ptrs, ws, S, splits, "bfloat16")
            call = lambda: fn(*args)  # noqa: E731
            if call():
                raise RuntimeError(f"{shape[0]} splits {splits}: launch "
                                   f"failed")
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            print(json.dumps({
                "sweep": shape[0], "pages": "int8" if int8 else "float",
                "splits": splits, "blocks": splits * KV * S,
                "ms": chip_smoke.time_ms(call, flush),
                "kernel_us": kernel_us(call, flush), "max_abs_err": err}),
                flush=True)


def measure(trees, flush, shape, dtype_name, int8):
    warm = torch.empty(16, dtype=torch.uint8, device="cuda")
    name, lengths = shape
    q, pages, tables, lens, want, qs, out, ptrs = _inputs(
        shape, dtype_name, int8)
    S, _, H, _ = q.shape
    splits = ops.decode_splits(S, KV, BS, BPS,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count)
    ws = torch.empty(splits * S * H * (D + 2), dtype=torch.float32,
                     device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    library_ms, bound_ms, bound_by = chip_smoke.decode_yardsticks(
        q, pages, tables, lens, N_REP, BS, flush)
    row = {"shape": name, "dtype": dtype_name,
           "pages": "int8" if int8 else "float", "lengths": lengths,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    labels = list(trees)
    for turn, order in enumerate((labels, labels[::-1])):
        for label in order:
            t = trees[label]
            fn = t["int8" if int8 else "float"]
            if t["split"]:
                args = _split_args(ptrs, ws, S, splits, dtype_name)
            else:
                args = (*ptrs, S, KV, N_REP, D, BS, BPS, DTYPES[dtype_name],
                        stream)
            call = lambda: fn(*args)  # noqa: E731
            out.fill_(float("nan"))
            if call():
                raise RuntimeError(f"{label} {name}: launch failed")
            torch.cuda.synchronize()
            if turn == 0:
                n_split = splits if t["split"] else 1
                row[f"{label} splits"] = n_split
                row[f"{label} blocks"] = n_split * KV * S
                row[f"{label} max_abs_err"] = err = float(
                    (out.float() - want.float()).abs().max())
                row[f"{label} ok"] = err <= chip_smoke.TOL[dtype_name]
                row[f"{label} kernel_us"] = kernel_us(call, flush)
            row.setdefault(f"{label} ms", []).append(
                chip_smoke.time_ms(call, flush))
            if turn == 0:   # L2 not flushed: the inputs stay resident
                row[f"{label} warm_ms"] = chip_smoke.time_ms(call, warm)
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    argv = sys.argv[1:]
    splits_list = []
    if "--splits" in argv:
        i = argv.index("--splits")
        splits_list = [int(n) for n in argv[i + 1].split(",")]
        del argv[i:i + 2]
    trees = dict(a.split("=", 1) for a in argv)
    if not trees:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = {label: build(label, tree) for label, tree in trees.items()}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for dtype_name in DTYPES:
        for int8 in (False, True):
            for shape in SHAPES:
                measure(built, flush, shape, dtype_name, int8)
    split_trees = [fns for fns in built.values() if fns["split"]]
    if splits_list and split_trees:
        for shape in SHAPES:
            sweep(split_trees[-1], flush, shape, splits_list)


if __name__ == "__main__":
    main()
