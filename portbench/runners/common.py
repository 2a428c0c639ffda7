"""What the runners share: the port's model configuration from a
configuration file, and the device's clock and memory."""

import gc
import time

import torch


def port_config(config, program, max_seq):
    """The port's ``transformer.Config`` for a configuration file's
    published keys, with the cell's ``program`` settings (``Config``
    fields: dtype, remat, the expert engine, ...) over the port's
    defaults."""
    from kubeflow_tpu_torch.compute.models import transformer
    return transformer.Config(**{
        "vocab_size": config["vocab_size"], "d_model": config["hidden_size"],
        "n_layers": config["num_hidden_layers"],
        "n_heads": config["num_attention_heads"],
        "n_kv_heads": config["num_key_value_heads"],
        "d_ff": config["intermediate_size"], "max_seq": int(max_seq),
        "rope_theta": float(config["rope_theta"]),
        "dtype": config["torch_dtype"],
        "moe_experts": config.get("num_local_experts") or 0,
        "moe_top_k": config.get("num_experts_per_tok") or 1,
        **program})


def dtype_of(name):
    return getattr(torch, name)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device):
    """The process's peak of allocated device memory (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sleep_until(t):
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def percentile(values, q):
    """The ``q``-th percentile, linearly interpolated between the two
    nearest ranks."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
