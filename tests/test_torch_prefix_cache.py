"""The port's prefix cache and chunked prefill against the JAX engine.

Both engines run the same sequential submissions on the same weights
(JAX ``init_params``, carried across with ``params_from_jax``) on the
CPU: the port's pool reads take the K2/K1 plain versions, the JAX
engine its default streamed reads. After every request the tokens and
the prefix/prefill counters (``prefix_hits``, ``prefix_misses``,
``prefix_tokens_skipped``, ``prefix_reclaims``, ``prefills``,
``prefill_chunks``) must be identical, and the tokens must equal the
port's cache-free oracle (``reference_greedy_decode``, itself held to
JAX's in ``tests/test_torch_generate.py``). The scenarios mirror
``tests/test_compute_generate.py`` ``TestPrefixCache`` and
``TestChunkedPrefill``: a shared-prefix hit, a partial-block boundary,
full-prompt hits, a hit across eviction, LRU reclaim under pressure,
chunked == monolithic, and a prefix hit with a chunked suffix. The
rest pins the port's own pool mechanics: the capacity gain, the block
partition, the snapshot, the interleave of chunks with decode steps and
the trie reset after a failed step.
"""

import dataclasses

import numpy as np
import pytest

import jax

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import paged_attention as t_paged
from kubeflow_tpu_torch.compute.params import params_from_jax

STATS = ("prefills", "prefill_chunks", "prefix_hits", "prefix_misses",
         "prefix_tokens_skipped", "prefix_reclaims")
LONG = list(range(1, 40))          # 39 tokens: 3 chunks at C=16


def _jcfg(dtype="float32"):
    return jt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, max_seq=64, dtype=dtype,
                     attention="dense", remat=False, scan_layers=True)


def _tcfg(dtype="float32"):
    j = _jcfg(dtype)
    return tt.Config(**{f.name: getattr(j, f.name)
                        for f in dataclasses.fields(tt.Config)})


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _kw(kw):
    kw = dict(kw)
    for k, v in (("max_slots", 2), ("block_size", 8), ("max_context", 64)):
        kw.setdefault(k, v)
    return kw


def _port(tparams, dtype="float32", **kw):
    return t_gen.GenerationEngine(tparams, _tcfg(dtype), device="cpu",
                                  **_kw(kw))


def _ref(tparams, prompt, n, dtype="float32"):
    return t_gen.reference_greedy_decode(tparams, _tcfg(dtype), prompt, n)


def _sequential(eng, steps):
    """Submit ``steps`` one after another → per step (tokens, counters)."""
    out = []
    for prompt, n in steps:
        toks, reason = eng.generate(prompt, max_tokens=n)
        assert reason == "length"
        out.append((toks, {k: eng.stats[k] for k in STATS}))
    return out


SHARED = list(range(1, 17))        # exactly 2 full blocks
SCENARIOS = {
    # name: (engine knobs, dtype, steps, counters after the last step)
    "shared_prefix_hit": (
        {}, "float32",
        [(SHARED + [40, 41, 42], 8), (SHARED + [50, 51], 8)],
        {"prefix_hits": 1, "prefix_misses": 1,
         "prefix_tokens_skipped": 16}),
    "partial_block_boundary": (
        {}, "float32",
        [([21] * 12 + [1, 2], 6), ([21] * 12 + [3, 4], 6)],
        {"prefix_hits": 1, "prefix_tokens_skipped": 8}),
    "full_prompt_hit": (
        {}, "float32",
        [([33] * 21, 6), ([33] * 21, 6), ([35] * 16, 6), ([35] * 16, 6)],
        {"prefix_hits": 2, "prefix_tokens_skipped": 16 + 8}),
    "hit_across_eviction": (
        {}, "float32",
        [([44] * 19 + [45], 5), ([44] * 19 + [45, 46], 5)],
        {"prefix_hits": 1, "prefix_tokens_skipped": 16}),
    "lru_reclaim_under_pressure": (
        {"max_slots": 1, "num_blocks": 5, "max_context": 40}, "float32",
        [([3] * 17, 8), ([5] * 17, 8), ([3] * 17, 8), ([5] * 17, 8)],
        None),
    "bf16_shared_prefix": (
        {}, "bfloat16",
        [(list(range(2, 18)) + [40, 41], 8),
         (list(range(2, 18)) + [50, 51, 52], 8)],
        {"prefix_hits": 1}),
    "disabled": (
        {"prefix_cache": False}, "float32",
        [(SHARED + [40], 5), (SHARED + [40], 5)],
        {"prefix_hits": 0, "prefix_misses": 0}),
    "chunked_monolithic_mix": (
        {"prefix_cache": False, "prefill_chunk": 16}, "float32",
        [([1, 2, 3], 8), (LONG, 8), ([5] * 17, 6)],
        {"prefills": 3, "prefill_chunks": 1 + 3 + 2}),
    "prefix_hit_then_chunked_suffix": (
        {"prefill_chunk": 16}, "float32",
        [(list(range(1, 20)) + [21, 22], 4),
         (list(range(1, 20)) + [21 + i for i in range(20)], 6)],
        {"prefix_hits": 1, "prefix_tokens_skipped": 16}),
    "chunked_prompt_then_hit": (
        {"prefill_chunk": 16}, "float32",
        [(LONG, 4), (LONG[:33] + [60, 61], 4)],
        {"prefix_hits": 1, "prefix_tokens_skipped": 32}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax_engine(jparams, tparams, name):
    kw, dtype, steps, expect = SCENARIOS[name]
    jeng = j_gen.GenerationEngine(jparams, _jcfg(dtype), name=f"tp-{name}",
                                  **_kw(kw))
    try:
        want = _sequential(jeng, steps)
    finally:
        jeng.close()
    t_paged.paged_chunk_attention.launches = 0
    eng = _port(tparams, dtype, **kw)
    try:
        got = _sequential(eng, steps)
        view = eng.blocks_view()
    finally:
        eng.close()
    assert got == want
    for (prompt, n), (toks, _) in zip(steps, got):
        assert toks == _ref(tparams, prompt, n, dtype), prompt
    final = got[-1][1]
    for k, v in (expect or {}).items():
        assert final[k] == v, (k, final)
    if name == "lru_reclaim_under_pressure":
        # the second prompt's cold prefill reclaimed the first one's LRU
        # pages; the most recent prompt still hits on its return
        assert final["prefix_reclaims"] >= 1 and final["prefix_hits"] >= 1
    if name == "disabled":
        assert not view["cached"]
        assert view["free"] == list(range(len(view["refcounts"])))
    # CPU tensors never launch a kernel
    assert t_paged.paged_chunk_attention.launches == 0


def test_shared_prefix_increases_effective_capacity(tparams):
    """The reservation charges only unshared blocks: a pool of 7 blocks
    cannot hold two cold 17-token sequences at once (4 blocks each),
    but runs two that share a cached 2-block prefix side by side."""
    shared = [7] * 16
    specs = [(shared + [11], 8), (shared + [12], 8)]
    cold = _port(tparams, num_blocks=7, prefix_cache=False)
    try:
        handles = [cold.submit(p, max_tokens=m) for p, m in specs]
        for (p, m), h in zip(specs, handles):
            assert h.result(timeout=120)[0] == _ref(tparams, p, m)
        assert cold.stats["decode_token_slots"] \
            == cold.stats["decode_steps"]                 # serialized
    finally:
        cold.close()
    warm = _port(tparams, num_blocks=7)
    try:
        warm.generate(shared + [10], max_tokens=2)       # seed the trie
        s0 = dict(warm.stats)
        handles = [warm.submit(p, max_tokens=m) for p, m in specs]
        for (p, m), h in zip(specs, handles):
            assert h.result(timeout=120)[0] == _ref(tparams, p, m)
        assert warm.stats["decode_token_slots"] - s0["decode_token_slots"] \
            > warm.stats["decode_steps"] - s0["decode_steps"]
        assert warm.stats["prefix_hits"] - s0["prefix_hits"] == 2
    finally:
        warm.close()


def _assert_partition(eng):
    view = eng.blocks_view()
    free, cached = set(view["free"]), set(view["cached"])
    referenced = set(view["referenced"])
    assert sorted(free | cached | referenced) == list(range(eng.num_blocks))
    assert not (free & cached or free & referenced or cached & referenced)
    for b in range(eng.num_blocks):
        assert view["refcounts"][b] == view["table_refs"].get(b, 0), b
    return view


def test_snapshot_and_block_partition(tparams):
    eng = _port(tparams)
    try:
        for _ in range(2):
            eng.generate([61] * 17, max_tokens=3)
        view = _assert_partition(eng)
        snap = eng.snapshot()
        assert snap["free_blocks"] == len(view["free"]) + len(view["cached"])
        pc = snap["prefix_cache"]
        assert pc["cached_blocks"] \
            == pc["reclaimable_blocks"] + pc["pinned_blocks"]
        assert pc["enabled"] and pc["hits"] == 1 and pc["misses"] == 1
        assert pc["hit_ratio"] == 0.5 and pc["tokens_skipped"] == 16
        assert view["cached"] and not view["referenced"]
    finally:
        eng.close()


def test_chunks_interleave_with_decode(tparams):
    """A long prompt admitted beside a decoding stream runs one chunk
    per loop iteration with a decode step between: the stream keeps
    emitting while the long slot prefills (prefilling slots sit out of
    the decode batch), and both outputs are the oracle's."""
    eng = _port(tparams, prefill_chunk=8)
    events = []
    try:
        short = eng.submit([1, 2, 3], max_tokens=12,
                           on_token=lambda t, i: events.append("s"))
        long_ = eng.submit(LONG, max_tokens=4,
                           on_token=lambda t, i: events.append("l"))
        assert short.result(timeout=120)[0] == _ref(tparams, [1, 2, 3], 12)
        assert long_.result(timeout=120)[0] == _ref(tparams, LONG, 4)
        stats = dict(eng.stats)
        _assert_partition(eng)
    finally:
        eng.close()
    assert stats["prefills"] == 2
    assert stats["prefill_chunks"] == 1 + 5      # 39 tokens at C=8
    first_long = events.index("l")
    # the short stream emitted between the long prompt's chunks
    assert events[:first_long].count("s") >= 5


def test_chunk_size_rounds_up_and_snapshot(tparams):
    eng = _port(tparams, prefix_cache=False, prefill_chunk=12)
    try:
        assert eng.prefill_chunk == 16
        out, _ = eng.generate(LONG, max_tokens=4)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert out == _ref(tparams, LONG, 4)
    assert snap["prefill_chunk"] == 16 and snap["prefill_chunks"] == 3
    assert snap["stats"]["prefills"] == 1


def test_debug_logits_needs_the_plain_path(tparams):
    for kw in ({}, {"prefix_cache": False, "prefill_chunk": 16}):
        with pytest.raises(ValueError, match="debug_logits"):
            _port(tparams, debug_logits=True, **kw)


def test_failed_step_drops_the_trie(tparams):
    """The pool is written in place, so a step that raised may have left
    partial pages: every slot fails, the trie is dropped, the pool is
    whole again and the next request misses, then serves the oracle."""
    eng = _port(tparams)
    try:
        prompt = SHARED + [9]
        eng.generate(prompt, max_tokens=3)
        assert eng.snapshot()["prefix_cache"]["cached_blocks"] == 2
        real = eng._decode_step

        def boom(*args):
            raise RuntimeError("device fell over")

        eng._decode_step = boom
        h = eng.submit(prompt, max_tokens=5)
        assert h.wait(60) and h.reason == "error"
        eng._decode_step = real
        view = _assert_partition(eng)
        assert not view["cached"] and len(view["free"]) == eng.num_blocks
        misses = eng.stats["prefix_misses"]
        assert eng.generate(prompt, max_tokens=5)[0] \
            == _ref(tparams, prompt, 5)
        assert eng.stats["prefix_misses"] == misses + 1
    finally:
        eng.close()


@pytest.mark.parametrize("backend", ["gather", "paged-kernel"])
@pytest.mark.parametrize("name", ["shared_prefix_hit",
                                  "prefix_hit_then_chunked_suffix"])
def test_chunk_read_backends_agree(tparams, backend, name):
    """The gather read (``chunk_attention`` over the materialized
    prefix) and ``paged-kernel`` give the default read's tokens and
    counters."""
    kw, dtype, steps, _ = SCENARIOS[name]
    outs = {}
    for b in ("paged", backend):
        eng = _port(tparams, dtype, attn_backend=b, **kw)
        try:
            outs[b] = _sequential(eng, steps)
        finally:
            eng.close()
    assert outs[backend] == outs["paged"]
    for (prompt, n), (toks, _) in zip(steps, outs[backend]):
        assert toks == _ref(tparams, prompt, n, dtype), prompt
