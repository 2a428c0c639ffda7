"""K6 and K7 in bf16 from several source trees, timed in one process.

    python3 hack/gmm_ab.py parent=build/parent change=.

Each ``label=path`` names a checkout of this repository (for a parent
commit: ``git archive <commit> | tar -x -C build/parent``, a git-ignored
directory). Its ``csrc/grouped_matmul.cu`` is compiled with the port's
``nvcc`` flags into ``build/gmm_ab/<label>/``, and the C entry points
``kubeflow_gmm`` (K6) and ``kubeflow_gmm_dw`` (K7) are called directly
on one set of tensors: no wrapper, so the time leaves out
``expert_tiles`` and the output's allocation. At each call site of the
MoE flagship's step (``chip_smoke.GMM_CASES`` and ``DW_CASES``, routing
from ``chip_smoke.moe_layout``), and for K6 at gate|up and K7 at dw
gate|up under the skewed routing as well, every tree runs in turns,
first to last then
last to first, each call timed by ``chip_smoke.time_ms`` (L2 flushed
before every call).

Prints the card's name and power limit, each build's registers and
spills per kernel (from ``nvcc -Xptxas -v``), then one JSON line per
site: ms per tree and turn, TFLOP/s of the first turn, and the largest
error against the plain PyTorch version relative to its max |value|.
Needs a CUDA device.
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
from kubeflow_tpu_torch.compute.ops import grouped_matmul as ops  # noqa: E402

CSRC = pathlib.Path("kubeflow_tpu_torch/compute/ops/csrc")
BF16 = 1   # the C interface's dtype code


def build(label, tree):
    """Compile the tree's ``grouped_matmul.cu`` → its ctypes entry points
    ``{"fwd": K6, "dw": K7}``."""
    out_dir = ROOT / "build" / "gmm_ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libgrouped_matmul.so"
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(pathlib.Path(tree) / CSRC / "grouped_matmul.cu")],
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
    fwd, dw = cdll.kubeflow_gmm, cdll.kubeflow_gmm_dw
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    dw.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fwd.restype = dw.restype = ctypes.c_int
    return {"fwd": fwd, "dw": dw}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def measure(trees, flush, layout, site, k, n, trans=None):
    """One call site: K6 (``trans`` True/False) or K7 (``trans`` None)."""
    _, be, fst, lst, m_pad = layout
    e, bm = chip_smoke.MOE_SHAPE["experts"], chip_smoke.MOE_SHAPE["block_m"]
    g = torch.Generator(device="cuda").manual_seed(k + n)
    x = chip_smoke._randn((m_pad, k), g, torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    if trans is None:
        dy = chip_smoke._randn((m_pad, n), g, torch.bfloat16)
        tiles = ops.expert_tiles(be, fst, lst, e).contiguous()
        out = torch.empty((e, k, n), device="cuda")
        want = ops.grouped_matmul_dw_reference(x, dy, be, fst, lst, e, bm)
        rows = int((tiles[:, 1] - tiles[:, 0]).sum()) * bm
        ptrs = (x, dy, tiles, out)
        dims = (m_pad, k, n, e, bm, BF16)
        kind = "dw"
    else:
        shape = (e, n, k) if trans else (e, k, n)
        w = chip_smoke._randn(shape, g, torch.bfloat16, k ** -0.5)
        w_kn = w.transpose(1, 2) if trans else w
        be32 = be.to(torch.int32).contiguous()
        out = torch.empty((m_pad, n), dtype=torch.bfloat16, device="cuda")
        want = ops.grouped_matmul_reference(x, w_kn, be, bm)
        rows = m_pad
        ptrs = (x, w, be32, out)
        dims = (m_pad, k, n, e, bm, int(trans), BF16)
        kind = "fwd"
    row = {"site": site, "kernel": "K7" if kind == "dw" else "K6",
           "rows": rows, "k": k, "n": n}
    labels = list(trees)
    for turn, order in enumerate((labels, labels[::-1])):
        for label in order:
            fn = lambda: trees[label][kind](  # noqa: E731
                *(t.data_ptr() for t in ptrs), *dims, stream)
            if fn():
                raise RuntimeError(f"{label} {site}: launch failed")
            torch.cuda.synchronize()
            ms = chip_smoke.time_ms(fn, flush)
            row.setdefault(f"{label} ms", []).append(ms)
            if turn == 0:
                row[f"{label} tflops"] = 2 * rows * k * n / ms / 1e9
                row[f"{label} rel_err"] = _rel(out, want)
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
    layout = chip_smoke.moe_layout()
    for site, k, n, trans in chip_smoke.GMM_CASES:
        measure(built, flush, layout, site, k, n, trans)
    for site, k, n in chip_smoke.DW_CASES:
        measure(built, flush, layout, site, k, n)
    skewed = chip_smoke.moe_layout(skewed=True)
    site, k, n, trans = chip_smoke.GMM_CASES[0]
    measure(built, flush, skewed, f"{site}_skewed", k, n, trans)
    site, k, n = chip_smoke.DW_CASES[0]
    measure(built, flush, skewed, f"{site}_skewed", k, n)


if __name__ == "__main__":
    main()
