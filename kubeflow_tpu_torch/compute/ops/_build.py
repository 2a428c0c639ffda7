"""Builds the port's hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kubeflow_tpu_torch/`` at the repository root (git-ignored),
named by a hash of its source and the flags, so an edited source
rebuilds and an unchanged one loads at once. The libraries are loaded
with ``ctypes``; no PyTorch headers are compiled, which keeps a build
to seconds. Nothing is fetched: only the CUDA toolkit is needed, and a
missing ``nvcc`` raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "kubeflow_tpu_torch")
SOURCES = ("paged_decode", "paged_chunk", "flash_fwd", "flash_bwd",
           "grouped_matmul", "fused_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
_ptxas = {}


def nvcc():
    """The ``nvcc`` on PATH, else under ``$CUDA_HOME``, else the
    toolkit's default install prefix; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled at first "
        "use and need the CUDA toolkit (put nvcc on PATH or set "
        "CUDA_HOME)")


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):     # the shared helpers
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every stale library in ``names``, one ``nvcc`` per
    source, all started together; returns the wall seconds. Raises with
    the compiler's output when a build fails."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        _ptxas[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(name):
    """What ``nvcc -Xptxas -v`` printed for ``name`` in this process
    (registers, shared memory and spills per kernel), or None when the
    library was already built."""
    return _ptxas.get(name)


def check_aligned(*tensors):
    """The kernels move data in 16-byte words: raise unless every
    tensor starts on a 16-byte boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must start on a 16-byte "
                             "boundary (pass a fresh contiguous tensor)")


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib
