"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a host without CUDA raises instead
of falling back silently — a CPU run must be asked for by name
(``device="cpu"``, as the tests do), so no number taken on the CPU can
pass for a device measurement.
"""

import subprocess

import torch


def resolve(device=None):
    """``None`` → the current CUDA card (``cuda:<index>``); anything
    else is taken as given, a CUDA device without an index getting the
    current one, so a served engine names its card exactly. Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    on a host that has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to "
            "run on the CPU explicitly (there is no silent fallback)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_identity():
    """The card's name and power limit exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card) — the tag every device number
    carries, since a card set below its maximum power runs slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
