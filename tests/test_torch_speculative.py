"""The port's speculative decoding against the JAX engine.

A draft proposes up to ``spec_k`` tokens per slot, one target forward
verifies them through the chunk read with per-slot prefix lengths (K2's
plain version on the CPU) and each slot keeps its longest agreeing
prefix plus the target's own next token. The output is the plain
engine's for any draft; the draft moves only the acceptance.

Mirrors ``tests/test_compute_generate.py`` ``TestSpeculativeDecoding``
on shared weights (JAX ``init_params`` carried across with
``params_from_jax``): sequential submissions give the JAX engine's
tokens and its ``spec_rounds`` / ``spec_proposed`` / ``spec_accepted``
/ ``decode_steps`` counters for a draft equal to the target, a
``truncated_draft`` pair and an unrelated random draft; the rest pins
the port's own mechanics (``spec_k=0`` is the plain engine byte for
byte, eos truncation, the block partition under churn, the knob checks,
a failed verify that heals).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax

STATS = ("spec_rounds", "spec_proposed", "spec_accepted", "decode_steps",
         "prefix_hits", "prefix_tokens_skipped")


def _jcfg(dtype="float32", **kw):
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=64, dtype=dtype, attention="dense",
                remat=False, scan_layers=True)
    base.update(kw)
    return jt.Config(**base)


def _tcfg(jcfg):
    return tt.Config(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(tt.Config)})


def _carry(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return _carry(jparams)


def _kw(kw):
    kw = dict(kw)
    for k, v in (("max_slots", 2), ("block_size", 8), ("max_context", 64)):
        kw.setdefault(k, v)
    return kw


def _port(tparams, cfg=None, **kw):
    return t_gen.GenerationEngine(tparams, cfg or _tcfg(_jcfg()),
                                  device="cpu", **_kw(kw))


def _self_draft(tparams, dtype="float32", k=3, **kw):
    cfg = _tcfg(_jcfg(dtype))
    return _port(tparams, cfg, draft_params=tparams, draft_config=cfg,
                 spec_k=k, **kw)


def _ref(tparams, prompt, n, cfg=None, eos_id=None):
    return t_gen.reference_greedy_decode(tparams, cfg or _tcfg(_jcfg()),
                                         prompt, n, eos_id=eos_id)


def _sequential(eng, steps):
    out = []
    for prompt, n in steps:
        toks, reason = eng.generate(prompt, max_tokens=n)
        assert reason == "length"
        out.append((toks, {k: eng.stats[k] for k in STATS}))
    return out


MIXED = [([1, 2, 3], 10), ([5] * 8, 10), (list(range(1, 18)), 10),
         (list(range(20, 36)) + [40, 41, 42], 8),
         (list(range(20, 36)) + [50, 51], 8)]


def _pair(kind, jparams, tparams):
    """→ (JAX (target, draft, draft config, k), port's, target config)."""
    if kind == "self":
        jc = _jcfg()
        return (jparams, jparams, jc, 3), (tparams, tparams, _tcfg(jc), 3), jc
    if kind == "truncated":
        jc = _jcfg(n_layers=4)
        j4 = jt.init_params(jc, jax.random.PRNGKey(3))
        jtarget, jdraft, jdc = j_gen.truncated_draft(j4, jc, 2, dampen=0.1)
        ttarget, tdraft, tdc = t_gen.truncated_draft(_carry(j4), _tcfg(jc),
                                                     2, dampen=0.1)
        # the port's dampened target is the JAX one, bit for bit
        for key in ("wo", "w_down"):
            np.testing.assert_array_equal(
                ttarget["layers"][key].numpy(),
                np.asarray(jtarget["layers"][key]))
        assert tdc == _tcfg(jdc)
        return (jtarget, jdraft, jdc, 3), (ttarget, tdraft, tdc, 3), jc
    # an unrelated random draft: proposals are mostly wrong
    jc = _jcfg()
    jdc = jt.Config(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                    max_seq=64, dtype="float32", attention="dense",
                    remat=False, scan_layers=True)
    jd = jt.init_params(jdc, jax.random.PRNGKey(9))
    return (jparams, jd, jdc, 4), (tparams, _carry(jd), _tcfg(jdc), 4), jc


@pytest.mark.parametrize("kind", ["self", "truncated", "garbage"])
def test_engine_matches_jax_engine(jparams, tparams, kind):
    (jtg, jd, jdc, k), (ttg, td, tdc, _), jc = _pair(kind, jparams, tparams)
    steps = MIXED[:3] if kind != "self" else MIXED
    jeng = j_gen.GenerationEngine(jtg, jc, name=f"ts-{kind}",
                                  draft_params=jd, draft_config=jdc,
                                  spec_k=k, **_kw({}))
    try:
        want = _sequential(jeng, steps)
    finally:
        jeng.close()
    eng = _port(ttg, _tcfg(jc), draft_params=td, draft_config=tdc, spec_k=k)
    try:
        got = _sequential(eng, steps)
    finally:
        eng.close()
    assert got == want
    for (prompt, n), (toks, _) in zip(steps, got):
        assert toks == _ref(ttg, prompt, n, _tcfg(jc)), prompt
    final = got[-1][1]
    assert final["spec_proposed"] > 0
    if kind == "self":
        # a perfect draft keeps all it may propose; the last two prompts
        # share two blocks
        assert final["spec_accepted"] == final["spec_proposed"]
        assert final["prefix_hits"] == 1
    elif kind == "truncated":
        assert final["spec_accepted"] > 0
    else:
        assert final["spec_accepted"] < final["spec_proposed"]


def test_spec_k0_is_the_plain_engine_byte_for_byte(tparams):
    plain = _port(tparams)
    off = _port(tparams, draft_params=tparams, draft_config=_tcfg(_jcfg()),
                spec_k=0)
    try:
        assert not off._spec_on and off.draft_params is None
        assert off.spec_view() is None
        for prompt, m in (([1, 2, 3], 8), ([5] * 9, 6), ([2, 60], 5)):
            assert plain.generate(prompt, max_tokens=m)[0] \
                == off.generate(prompt, max_tokens=m)[0]
        for a, b in zip(plain._cache, off._cache):
            assert torch.equal(a, b)
        assert plain.stats["decode_steps"] == off.stats["decode_steps"]
    finally:
        plain.close()
        off.close()


def test_token_identical_across_eviction_admission_boundary(tparams):
    """Staggered budgets over 2 slots and a queue: slots evict mid-round
    and queued prompts take them; every output is the oracle's."""
    eng = _self_draft(tparams)
    try:
        specs = [([1, 2, 3], 16), ([5, 6, 7, 8, 9], 4), ([4] * 11, 9),
                 ([60, 2], 12)]
        handles = [eng.submit(p, max_tokens=m) for p, m in specs]
        for (prompt, m), h in zip(specs, handles):
            assert h.result(timeout=120) == (_ref(tparams, prompt, m),
                                             "length")
        assert eng.stats["decode_token_slots"] > eng.stats["decode_steps"]
    finally:
        eng.close()


def test_bf16_token_identical(tparams):
    cfg = _tcfg(_jcfg("bfloat16"))
    eng = _self_draft(tparams, "bfloat16")
    try:
        specs = [([1, 2, 3], 12), ([5, 6, 7, 8, 9], 4), ([4] * 11, 8)]
        handles = [eng.submit(p, max_tokens=m) for p, m in specs]
        for (prompt, m), h in zip(specs, handles):
            assert h.result(timeout=120)[0] == _ref(tparams, prompt, m, cfg)
    finally:
        eng.close()


def test_chunked_prefill_under_speculation(tparams):
    """A chunked prompt's draft prefill runs at its last chunk; the
    verify then reads a pool the chunks wrote."""
    eng = _self_draft(tparams, prefill_chunk=16)
    try:
        prompt = list(range(1, 40))
        assert eng.generate(prompt, max_tokens=9)[0] \
            == _ref(tparams, prompt, 9)
        assert eng.stats["prefill_chunks"] == 3
        assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"] > 0
    finally:
        eng.close()


def test_eos_truncates_stream_and_cache(tparams):
    """No token past the eos reaches the stream or the retained cache."""
    eng = _self_draft(tparams)
    try:
        prompt = [1, 2, 3]
        ref = _ref(tparams, prompt, 12)
        eos = ref[5]                       # mid-round for k=3
        ref_eos = _ref(tparams, prompt, 12, eos_id=eos)
        seen = []
        h = eng.submit(prompt, max_tokens=12, eos_id=eos,
                       on_token=lambda t, i: seen.append((t, i)))
        out, reason = h.result(timeout=120)
        assert reason == "eos" and out == ref_eos
        assert out[-1] == eos and eos not in out[:-1]
        assert seen == [(t, i) for i, t in enumerate(out)]
        view = eng.blocks_view()
        assert not view["referenced"]
        assert all(b in eng._node_by_block for b in view["cached"])
    finally:
        eng.close()


def test_done_time_view_includes_the_final_round(tparams):
    eng = _self_draft(tparams, k=4, max_slots=1)
    captured = {}
    try:
        h = eng.submit([1, 2, 3], max_tokens=6,
                       on_done=lambda r, t, e: captured.update(
                           view=eng.spec_view()))
        h.result(timeout=120)
        # prefill token + 4 accepted + the bonus token: one round
        assert h.spec_rounds == 1
        assert captured["view"]["proposed"] == h.spec_proposed == 4
        assert captured["view"]["accepted"] == 4
        assert captured["view"]["acceptance_ratio"] == 1.0
        view = eng.spec_view(h)
        assert view["k"] == 4 and view["steps"] == 1
        assert len(h.out_tokens) == 1 + h.spec_accepted + h.spec_rounds
        assert view["accepted_per_step"] == 4.0
        assert eng.snapshot()["speculative"]["k"] == 4
    finally:
        eng.close()


def test_block_partition_survives_spec_churn(tparams):
    eng = _self_draft(tparams, num_blocks=10, max_context=48)
    try:
        specs = [([9] * 16 + [1], 6), ([9] * 16 + [2], 6), ([11] * 8, 5),
                 ([13] * 19, 4)]
        handles = [eng.submit(p, max_tokens=m) for p, m in specs]
        for h in handles:
            assert h.wait(timeout=120)
        view = eng.blocks_view()
        free, cached = set(view["free"]), set(view["cached"])
        referenced = set(view["referenced"])
        assert sorted(free | cached | referenced) \
            == list(range(eng.num_blocks))
        assert not (free & cached or free & referenced
                    or cached & referenced)
        for b in range(eng.num_blocks):
            assert view["refcounts"][b] == view["table_refs"].get(b, 0), b
        for (prompt, m), h in zip(specs, handles):
            assert h.out_tokens == _ref(tparams, prompt, m), prompt
    finally:
        eng.close()


def test_failed_verify_heals(tparams):
    """A verify that raised after writing part of the pool fails its
    requests and drops the trie; the engine then serves the oracle."""
    eng = _self_draft(tparams, max_slots=1)
    try:
        real = eng._verify_step

        def boom(*args):
            real(*args)                 # the pool is written in place
            raise RuntimeError("device fell over")

        eng._verify_step = boom
        h = eng.submit(list(range(1, 18)), max_tokens=6)
        assert h.wait(60) and h.reason == "error"
        eng._verify_step = real
        assert not eng.blocks_view()["cached"]
        assert eng.generate(list(range(1, 18)), max_tokens=6)[0] \
            == _ref(tparams, list(range(1, 18)), 6)
    finally:
        eng.close()


def test_knob_validation(tparams):
    cfg = _tcfg(_jcfg())
    with pytest.raises(ValueError, match="spec_k"):
        _port(tparams, spec_k=-1)
    with pytest.raises(ValueError, match="draft"):
        _port(tparams, spec_k=2)                        # no draft
    with pytest.raises(ValueError, match="draft_config"):
        _port(tparams, draft_params=tparams, spec_k=2)
    small = _jcfg(vocab_size=32, d_model=16, n_layers=1, n_heads=2,
                  n_kv_heads=1)
    with pytest.raises(ValueError, match="vocab"):
        _port(tparams, spec_k=2,
              draft_params=_carry(jt.init_params(small,
                                                 jax.random.PRNGKey(1))),
              draft_config=_tcfg(small))
    with pytest.raises(ValueError, match="debug_logits"):
        _port(tparams, prefix_cache=False, debug_logits=True,
              draft_params=tparams, draft_config=cfg, spec_k=2)
    for bad in (0, 2):
        with pytest.raises(ValueError, match="draft_layers"):
            t_gen.truncated_draft(tparams, cfg, bad)


def test_gather_verify_read(tparams):
    """The verify through the gather read (``chunk_attention`` with a
    per-slot ``[B]`` prefix) gives the oracle's tokens at full
    acceptance."""
    eng = _self_draft(tparams, attn_backend="gather")
    try:
        got = _sequential(eng, MIXED[:3])
    finally:
        eng.close()
    for (prompt, n), (toks, _) in zip(MIXED[:3], got):
        assert toks == _ref(tparams, prompt, n), prompt
    final = got[-1][1]
    assert final["spec_accepted"] == final["spec_proposed"] > 0
