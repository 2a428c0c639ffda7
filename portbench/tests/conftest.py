"""Shared pieces of the benchmark's tests: the ``cuda`` marker, a
fixture that skips without a card, and tiny versions of the cells'
configurations, mixes and settings for CPU runs.

The tiny cells run the program in float32 and carry limits of their
own, set from their own readings on the CPU (``portbench.control`` at
these sizes): the program reads at most 1e-6 in every training number
and 0 in the served gap; the float8 control reads at least 2.3e-3 in
the loss, 2.6e-2 in the first gradient and 0.23 in the served gap, and
half of each batch left out at least 9.8e-3 in the loss."""

import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without CUDA)")


@pytest.fixture()
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return "cuda"


def _load(*parts):
    return json.loads(HERE.joinpath(*parts).read_text())


TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=128, vocab_size=256)


@pytest.fixture()
def tiny_serve():
    """``(config, mix, settings)`` of a tiny ``mistral-7b.docqa``: the
    program in float32, a 4-slot engine and 4 callers, 2–6 token
    answers."""
    cfg = dict(_load("configs", "mistral-7b.json"), **TINY)
    mix = dict(_load("traffic", "docqa.json"),
               prompt_tokens={"dist": "loguniform", "min": 20, "max": 60},
               output_tokens={"dist": "uniform", "min": 2, "max": 6},
               clients=4, lead_s=1, tail_s=1, warmup_requests=2,
               warmup_output_tokens=2)
    st = dict(_load("workloads", "mistral-7b.docqa.json"),
              program={"dtype": "float32"},
              engine={"max_slots": 4, "block_size": 16, "max_context": 128,
                      "num_blocks": 64, "default_max_tokens": 8},
              wait_s=10, trace_stretch_s=1, limits={"widest_gap": 0.05})
    return cfg, mix, st


@pytest.fixture()
def tiny_train():
    """``(config, mix, settings)`` of a tiny ``mixtral-8x7b.train-4k``:
    the program in float32, 4 experts, 4 × 64 tokens a step."""
    cfg = dict(_load("configs", "mixtral-8x7b.json"), **TINY,
               num_local_experts=4)
    mix = dict(_load("traffic", "train-4k.json"), batch=4, seq=64,
               mean_doc_tokens=16)
    st = _load("workloads", "mixtral-8x7b.train-4k.json")
    st["program"] = dict(st["program"], dtype="float32")
    st.update(batches=8, reference_block=16,
              limits={"loss_rel_gap": 1e-3, "grad_norm_gap": 1e-3,
                      "change_norm_gap": 1e-3})
    return cfg, mix, st


@pytest.fixture()
def bench():
    """``BENCHMARK.json`` with the training cell ``mixtral-8x7b.train-4k``
    entered as its files describe it (it is kept out of the benchmark
    while the program's embedding gradient is at fault; PERF.md)."""
    b = _load("..", "BENCHMARK.json")
    names = {c["name"] for c in b["configs"]}
    if "mixtral-8x7b" not in names:
        b["configs"].append({"name": "mixtral-8x7b",
                             "file": "portbench/configs/mixtral-8x7b.json"})
    if all(w["name"] != "mixtral-8x7b.train-4k" for w in b["workloads"]):
        b["workloads"].append({"name": "mixtral-8x7b.train-4k",
                               "config": "mixtral-8x7b",
                               "traffic": "train-4k", "chips": 1})
    return b
