"""Profiling: ``torch.profiler`` traces written to the Tensorboard logs
path.

Port of ``kubeflow_tpu/compute/profiler.py``: a workload writes its
trace under ``<logs>/plugins/profile`` — the path the Tensorboard CR's
profile plugin reads — here as a Chrome trace (``*.pt.trace.json``)
with the CPU ops and, on a card, the CUDA kernels.
:func:`device_summary` reads a finished capture: the card's busy time,
its idle share and where its time went, by kernel and kernel group.
"""

import contextlib
import dataclasses
import os
import socket
import threading
import time

import torch


class ProfilerActiveError(RuntimeError):
    """A second ``trace()`` was opened while one is already capturing.
    The profiler's CUPTI session is process-global; this named error
    fails fast at the platform boundary instead of deep inside it."""


_active_lock = threading.Lock()
_active_base = None


def trace_dir(base=None):
    """Resolve the logs path: explicit arg > TENSORBOARD_LOGDIR (the env
    the PodDefault injects) > ./logs."""
    base = base or os.environ.get("TENSORBOARD_LOGDIR", "./logs")
    return os.path.join(base, "plugins", "profile")


@dataclasses.dataclass
class Capture:
    """What ``trace()`` yields: the live ``torch.profiler.profile``
    (``key_averages()`` after the block) and, once the block has closed,
    the path of the Chrome trace it wrote."""
    profile: object
    path: str = None


@contextlib.contextmanager
def trace(logdir=None):
    """Capture a profiler trace for the enclosed steps:

        with profiler.trace("/workspace/logs") as cap:
            for _ in range(10):
                state, _ = step(state, batch)
        print(cap.path, cap.profile.key_averages())

    Traces the CPU and, when there is a card, CUDA kernels; the card is
    synchronised before the capture stops, so every kernel the steps
    queued is in it. Crash-safe: the profiler stops and the trace is
    written even when the enclosed block raises, and the process-global
    session is released for the next attempt. Opening a second
    ``trace()`` while one is active raises ``ProfilerActiveError``."""
    global _active_base
    base = logdir or os.environ.get("TENSORBOARD_LOGDIR", "./logs")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with _active_lock:
        if _active_base is not None:
            raise ProfilerActiveError(
                f"a profiler trace is already capturing to "
                f"{_active_base!r}; close it before opening another "
                f"(the profiler session is process-global)")
        out_dir = trace_dir(base)
        os.makedirs(out_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts, acc_events=True)
        prof.start()
        _active_base = base
    cap = Capture(profile=prof)
    try:
        yield cap
    finally:
        with _active_lock:
            _active_base = None
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            finally:
                prof.stop()
                cap.path = os.path.join(
                    out_dir, f"{socket.gethostname()}.{os.getpid()}."
                             f"{time.time_ns()}.pt.trace.json")
                prof.export_chrome_trace(cap.path)


#: kernel groups of :func:`device_summary`: the port's own kernels by
#: symbol, then library kernels by kind; the first group that matches
#: a kernel's name takes it
KERNEL_GROUPS = (
    ("K1 paged_decode", ("paged_decode_kernel",
                         "paged_decode_combine_kernel")),
    ("K2 paged_chunk", ("paged_chunk_kernel", "paged_chunk_tc_kernel",
                        "paged_chunk_combine_kernel")),
    ("K3 flash_fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
    ("K4 flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel")),
    ("K5 flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                          "flash_bwd_dkv_tc_kernel")),
    ("K6 grouped_matmul", ("gmm_fwd_kernel", "gmm_fwd_wgmma_kernel")),
    ("K7 grouped_matmul_dw", ("gmm_dw_kernel", "gmm_dw_wgmma_kernel")),
    ("K8 fused_block", ("fused_block_kernel",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "cudnn", "conv2d",
                     "implicit_gemm", "convolve")),
    ("pooling", ("pool",)),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("reduction", ("reduce_kernel", "softmax", "norm_kernel")),
    ("index/scatter", ("index", "scatter", "gather", "embedding")),
    ("elementwise", ("elementwise_kernel", "copy", "cat_")),
)


def kernel_group(name):
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def device_summary(prof, wall_ms, steps=1, top=10):
    """What a finished ``torch.profiler`` capture of ``steps`` steps says
    of the card, per step: ``device_ms`` (the CUDA kernels' time; CPU
    ops, which also carry their kernels' time, are left out so nothing
    counts twice), the share of ``wall_ms`` (host ms a step) the device
    sat idle, device ms by :data:`KERNEL_GROUPS` group, and the ``top``
    kernels. Raises when the capture holds no CUDA kernel."""
    from torch.autograd import DeviceType

    def dev_ms(e):
        # FunctionEventAvg renamed cuda_* to device_* over torch releases
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        return us / 1e3 / steps

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler saw no CUDA kernels")
    device_ms = sum(dev_ms(e) for e in kernels)
    groups = {}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + dev_ms(e)
    kernels.sort(key=lambda e: -dev_ms(e))
    return {"host_wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": e.key[:90], "calls": e.count / steps,
                             "ms": dev_ms(e)} for e in kernels[:top]]}


class StepTimer:
    """Lightweight per-step wall-time metrics (no trace overhead):
    throughput + EMA step time. On a card, call ``tick()`` after a
    synchronise, or it times the enqueue."""

    def __init__(self, ema=0.9):
        self._ema = ema
        self.step_time = None
        self.last = None

    def tick(self):
        now = time.perf_counter()
        if self.last is not None:
            dt = now - self.last
            self.step_time = (dt if self.step_time is None
                              else self._ema * self.step_time
                              + (1 - self._ema) * dt)
        self.last = now
        return self.step_time

    def throughput(self, items_per_step):
        if not self.step_time:
            return None
        return items_per_step / self.step_time
