"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BYTES_PER_S = 3.35e12                 # HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # tensor cores
              "float16": 989e12,
              "float32": 67e12}       # outside the tensor cores


def peaks_for(device_kind):
    """``(PEAK_FLOPS, BYTES_PER_S)`` for a card of this name, or None
    for a device whose peaks the benchmark does not hold (a CPU, another
    card): a share of a peak is then not reported."""
    if device_kind and "H100" in device_kind:
        return PEAK_FLOPS, BYTES_PER_S
    return None
