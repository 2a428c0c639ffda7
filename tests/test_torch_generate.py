"""The port's greedy generation engine against the JAX reference.

The port's engine runs on ``device="cpu"`` (the kernels' plain
versions), fp32, GQA, 2 slots, block size 8, over the five-prompt churn
set of ``tests/test_paged_attention.py`` — mixed budgets over 2 slots
force mid-batch evict/admit. The JAX side is its
``reference_greedy_decode`` oracle and its engine (``prefix_cache=False``)
on the same weights, carried across through numpy.

Tokens must be identical; per-token logits within atol 1e-4 / rtol 1e-3
(fp32 reduction order: the port's prefill runs the flash forward where
the JAX engine runs dense attention).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax

from kubeflow_tpu.compute import conformance as j_conf
from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import conformance as t_conf
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import flash_attention as t_flash
from kubeflow_tpu_torch.compute.ops import paged_attention as t_paged
from kubeflow_tpu_torch.compute.params import params_from_jax

PROMPTS = [([3, 9, 1, 22, 7, 15, 2], 12), ([5, 5, 44], 4),
           ([9] * 17, 9), ([2, 61, 30, 8], 6), ([1] * 11, 5)]


def _jcfg():
    return jt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, max_seq=64, dtype="float32",
                     attention="dense", remat=False, scan_layers=True)


def _tcfg():
    j = _jcfg()
    return tt.Config(**{f.name: getattr(j, f.name)
                        for f in dataclasses.fields(tt.Config)})


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           device="cpu")


@pytest.fixture(scope="module")
def oracle(jparams):
    """JAX's cache-free oracle: (tokens, logits rows) per prompt."""
    return [j_conf.reference_logits(jparams, _jcfg(), p, m)
            for p, m in PROMPTS]


@pytest.fixture(scope="module")
def jax_engine_out(jparams):
    eng = j_gen.GenerationEngine(
        jparams, _jcfg(), max_slots=2, block_size=8, max_context=64,
        prefix_cache=False, debug_logits=True, name="torch-parity")
    try:
        handles = [eng.submit(p, max_tokens=m) for p, m in PROMPTS]
        return [(h.result(timeout=300)[0], h.logits) for h in handles]
    finally:
        eng.close()


def _port_churn(tparams, backend):
    eng = t_gen.GenerationEngine(
        tparams, _tcfg(), max_slots=2, block_size=8, max_context=64,
        prefix_cache=False, debug_logits=True, attn_backend=backend,
        device="cpu")
    try:
        handles = [eng.submit(p, max_tokens=m) for p, m in PROMPTS]
        outs = [(h.result(timeout=300)[0], h.logits) for h in handles]
        return outs, eng.snapshot()
    finally:
        eng.close()


@pytest.mark.parametrize("backend", ["paged", "paged-kernel", "gather"])
def test_engine_matches_jax_oracle_and_engine(tparams, oracle,
                                              jax_engine_out, backend):
    for fn in (t_paged.paged_decode_attention, t_flash.flash_attention):
        fn.launches = 0
    outs, snap = _port_churn(tparams, backend)
    # the churn really churned: more requests than slots, all served
    assert snap["stats"]["prefills"] == len(PROMPTS)
    assert snap["stats"]["peak_occupancy"] == 2
    assert snap["free_blocks"] == snap["blocks"]
    for (toks, logits), (want, rows), (jtoks, jlogits), (_, m) in zip(
            outs, oracle, jax_engine_out, PROMPTS):
        assert toks == want == jtoks
        assert len(logits) == m
        t_conf.assert_logits_close(logits, rows, atol=1e-4, rtol=1e-3,
                                   what="port engine vs JAX oracle")
        t_conf.assert_logits_close(logits, jlogits, atol=1e-4, rtol=1e-3,
                                   what="port engine vs JAX engine")
    # CPU tensors never reach a kernel: the wrappers took their plain
    # versions, so no launch was counted
    assert t_paged.paged_decode_attention.launches == 0
    assert t_flash.flash_attention.launches == 0


def test_port_oracle_matches_jax_oracle(tparams, oracle):
    for (p, m), (want, rows) in zip(PROMPTS, oracle):
        toks, got = t_gen.reference_greedy_decode(
            tparams, _tcfg(), p, m, collect_logits=True)
        assert toks == want
        t_conf.assert_logits_close(got, rows, atol=1e-4, rtol=1e-3,
                                   what="port oracle vs JAX oracle")


def test_engine_needs_a_device_without_cuda(tparams):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_gen.GenerationEngine(tparams, _tcfg())


def test_engine_eos_cancel_and_drain(tparams):
    eng = t_gen.GenerationEngine(tparams, _tcfg(), max_slots=2,
                                 block_size=8, max_context=64,
                                 device="cpu")
    try:
        first = eng.generate([3, 9, 1], max_tokens=1)[0][0]
        out, reason = eng.generate([3, 9, 1], max_tokens=20, eos_id=first)
        assert (out, reason) == ([first], "eos")
        with pytest.raises(ValueError, match="max_context"):
            eng.submit([1] * 60, max_tokens=10)
        # cancel from the first token's callback: the slot is evicted
        # before its budget runs out
        ready, box = threading.Event(), {}

        def on_token(token, index):
            ready.wait(10)
            eng.cancel(box["h"])

        box["h"] = h = eng.submit([1, 2, 3], max_tokens=40,
                                  on_token=on_token)
        ready.set()
        assert h.wait(60) and h.reason == "cancelled"
        assert 1 <= len(h.out_tokens) < 40
        eng.begin_drain()
        with pytest.raises(t_gen.DrainingError):
            eng.submit([1, 2], max_tokens=2)
    finally:
        eng.close()
    assert not eng.thread.is_alive()
    snap = eng.snapshot()
    assert snap["occupied"] == 0 and snap["free_blocks"] == snap["blocks"]
