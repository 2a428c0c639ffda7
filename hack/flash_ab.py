"""K3, K4 and K5 in bf16 from several source trees, timed in one process.

    python3 hack/flash_ab.py parent=build/parent change=.

Each ``label=path`` names a checkout of this repository (for a parent
commit: ``git archive <commit> | tar -x -C build/parent``, a git-ignored
directory). Its ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` are
compiled with the port's ``nvcc`` flags into ``build/flash_ab/<label>/``,
and the C entry points ``kubeflow_flash_fwd`` (K3),
``kubeflow_flash_bwd_dq`` (K4) and ``kubeflow_flash_bwd_dkv`` (K5) are
called directly on one set of tensors: no wrapper, so no ``_prescale`` pass and no host-side checks
in the time. At each of the main path's attention shapes (serving
prefill B 1, the dense train step, the MoE step, the BERT step) every
tree runs in turns, first to last then last to first, each call timed
by ``chip_smoke.time_ms`` (L2 flushed before every call).

Prints the card's name and power limit, each build's registers and
spills per bf16 flash kernel (from ``nvcc -Xptxas -v``), then one JSON
line per shape: ms per tree and turn, and each output's largest error
against the plain PyTorch version (K3: |out| and |lse|; K4: dq, K5: dk
and dv, relative to the plain gradient's max |value|). Needs a CUDA device.
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
import chip_smoke  # noqa: E402
from kubeflow_tpu_torch.compute.ops import _build  # noqa: E402
from kubeflow_tpu_torch.compute.ops import flash_attention as ops  # noqa: E402

CSRC = pathlib.Path("kubeflow_tpu_torch/compute/ops/csrc")
# (B, S, H, kv_heads, D, causal), as chip_smoke.py's kernels phase
SHAPES = {"serving": (1, 1024, 8, 2, 128, True),
          "train": (16, 1024, 8, 2, 128, True),
          "moe": (8, 1024, 8, 8, 128, True),
          "bert": (16, 512, 12, 12, 64, False)}
KERNEL_IDS = {"fwd": "K3", "dq": "K4", "dkv": "K5"}


def build(label, tree):
    """Compile the tree's two flash sources at once → their ctypes entry
    points ``{"fwd": K3, "dq": K4, "dkv": K5}``."""
    out_dir = ROOT / "build" / "flash_ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kind, name in (("fwd", "flash_fwd"), ("dkv", "flash_bwd")):
        src = pathlib.Path(tree) / CSRC / f"{name}.cu"
        procs[kind] = (out_dir / f"lib{name}.so", subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for kind, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed:\n{log}")
        for kernel, e in chip_smoke.ptxas_entries(log).items():
            if "bf16" in kernel or "_tc_" in kernel:
                print(json.dumps({"tree": label, "kernel": kernel,
                                  **{k: e[k] for k in (
                                      "registers", "spill_stores",
                                      "spill_loads")}}), flush=True)
        if kind == "fwd":
            fns[kind] = ab_entry.entry(
                ctypes.CDLL(str(lib)), "kubeflow_flash_fwd",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                + [ctypes.c_void_p])
            continue
        for name, n_ptr in (("dq", 7), ("dkv", 8)):
            fn = getattr(ctypes.CDLL(str(lib)), f"kubeflow_flash_bwd_{name}")
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def measure(trees, flush, shape):
    B, S, H, kv, D, causal = SHAPES[shape]
    g = torch.Generator().manual_seed(3)
    q, do = (torch.randn((B, S, H, D), generator=g).to("cuda", torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((B, S, kv, D), generator=g).to("cuda", torch.bfloat16)
            for _ in range(2))
    qs = ops._prescale(q, None).contiguous()
    want, want_lse = ops.flash_attention_reference(q, k, v, causal)
    delta = ops.attention_delta(want, do)
    want_dq, want_dk, want_dv = ops._bwd_reference(q, k, v, do, want_lse,
                                                   delta, causal, None)
    out, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, S), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    dims = (B, S, S, H, kv, D, int(causal), 1)

    def call(fns, kind):
        if kind == "fwd":
            args = (qs, k, v, out, lse)
            return fns["fwd"](*(t.data_ptr() for t in args), *dims, stream)
        outs = (dq,) if kind == "dq" else (dk, dv)
        args = (q, k, v, do, want_lse, delta, *outs)
        return fns[kind](*(t.data_ptr() for t in args), *dims, D ** -0.5,
                         stream)

    row = {"shape": shape, "B": B, "S": S, "H": H, "kv_heads": kv, "D": D,
           "causal": causal}
    labels = list(trees)
    for kind in ("fwd", "dq", "dkv"):
        for label in labels + labels[::-1]:
            fn = lambda: call(trees[label], kind)  # noqa: E731
            if fn():
                raise RuntimeError(f"{label} {kind}: launch failed")
            torch.cuda.synchronize()
            if kind == "fwd":
                err = {"out": float((out.float() - want.float()).abs().max()),
                       "lse": float((lse - want_lse).abs().max())}
            elif kind == "dq":
                err = {"dq": _rel(dq, want_dq)}
            else:
                err = {"dk": _rel(dk, want_dk), "dv": _rel(dv, want_dv)}
            key = f"{KERNEL_IDS[kind]} {label}"
            row.setdefault(f"{key} ms", []).append(
                chip_smoke.time_ms(fn, flush))
            row[f"{key} err"] = err
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
    for shape in SHAPES:
        measure(built, flush, shape)


if __name__ == "__main__":
    main()
