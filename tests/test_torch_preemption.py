"""Preemptible decoding on the port against the JAX engine.

Every case of ``tests/test_generate_preemption.py`` on the port's engine
(``device="cpu"``: the kernels' plain versions), at that file's config
(vocab 64, d_model 32, 2 layers) with JAX's weights carried across by
``params_from_jax``: under interactive-class pressure a batch-class
slot SUSPENDS mid-stream (its written K/V indexed into the prefix trie,
its pages released cache-retained, the request re-queued), then
RESUMES as a prefill of prompt + emitted tokens whose matched prefix
skips all but the last block or two, and the stream goes on exactly as
the uninterrupted greedy decode would (JAX's ``reference_greedy_decode``
in fp32, the port's own oracle in bf16). Plus priority admission, the
engine-side budget deferral on the port's ``qos.TokenLedger``, strict
FIFO (``preemption=False``), the lifecycle events, snapshot, timeline
and done view against JAX's on the same schedule, a chunked resume and
an int8-pool resume against a JAX engine on the same weights, and the
token telemetry (``token_times``, ``token_latency_stats``).

The suspension step depends on timing (``_step_sleep`` holds the victim
in its slot), so tokens are compared with an oracle, never the step at
which each engine suspended. Every wait is bounded by ``LIMIT``.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax
from kubeflow_tpu_torch.obs import metrics as t_metrics
from kubeflow_tpu_torch.qos import buckets as qos_lib

LIMIT = 60.0         # seconds any one wait of a test may take
PROMPT = [5, 9, 3, 7, 11, 2]


def _jcfg(dtype="float32"):
    return jt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     max_seq=64, dtype=dtype, attention="dense",
                     remat=False, scan_layers=True)


def _tcfg(dtype="float32"):
    j = _jcfg(dtype)
    return tt.Config(**{f.name: getattr(j, f.name)
                        for f in dataclasses.fields(tt.Config)})


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _kw(kw):
    kw.setdefault("max_slots", 1)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("name", "t")
    return kw


def _engine(params, dtype="float32", **kw):
    return t_gen.GenerationEngine(params, _tcfg(dtype), device="cpu",
                                  **_kw(kw))


def _jax_engine(jparams, dtype="float32", **kw):
    return j_gen.GenerationEngine(jparams, _jcfg(dtype), **_kw(kw))


def _ref(jparams, prompt, max_tokens):
    return j_gen.reference_greedy_decode(jparams, _jcfg(), prompt,
                                         max_tokens)


def _until(cond, what):
    deadline = time.monotonic() + LIMIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _preempt_once(engine, prompt=PROMPT, max_tokens=24, min_tokens=5,
                  events=None):
    """One batch-class stream on a saturated engine, an interactive
    admission fired mid-stream → both finished handles."""
    engine._step_sleep = 0.01
    try:
        batch = engine.submit(
            prompt, max_tokens=max_tokens, tenant="crawler",
            qos_class="batch",
            on_event=(lambda ev, at: events.append((ev, at)))
            if events is not None else None)
        _until(lambda: len(batch.out_tokens) >= min_tokens,
               "the victim never decoded")
        inter = engine.submit([4, 4, 8], max_tokens=4, tenant="acme",
                              qos_class="interactive")
        inter.result(timeout=LIMIT)
        batch.result(timeout=LIMIT)
    finally:
        engine._step_sleep = 0.0
    return batch, inter


def _closing(engine, fn):
    try:
        return fn(engine)
    finally:
        engine.close()


class TestPreemptResumeIdentity:
    def test_fp32_resumed_stream_matches_jax_oracle(self, params, jparams):
        engine = _engine(params)
        events = []
        batch, inter = _closing(
            engine, lambda e: _preempt_once(e, events=events))
        assert batch.preemptions >= 1
        assert batch.out_tokens == _ref(jparams, PROMPT, 24)
        assert inter.out_tokens == _ref(jparams, [4, 4, 8], 4)
        assert inter.preemptions == 0
        # the retained pages covered at least the prompt, and the
        # re-computed tail is at most two blocks
        assert batch.prefix_tokens_skipped >= len(PROMPT)
        assert 0 < batch.resume_prefill_tokens <= 2 * engine.block_size
        names = [ev for ev, _ in events]
        assert names[0] == "suspended" and "resumed" in names
        sus = events[0][1]
        assert sus["reason"] == "preempted" and 0 < sus["tokens"] < 24
        res = events[names.index("resumed")][1]
        assert res["prefix_tokens_skipped"] == batch.prefix_tokens_skipped
        assert res["tokens"] == sus["tokens"]
        assert engine.stats["preemptions"] >= 1
        assert engine.stats["resumes"] == engine.stats["preemptions"]
        assert engine.stats["resume_prefill_tokens"] \
            == batch.resume_prefill_tokens
        # the resumed stream's indices continue: one stamp a token
        assert len(batch.token_times) == len(batch.out_tokens) == 24

    def test_events_match_jax_in_order_and_keys(self, params, jparams):
        got = {}
        for side, engine in (("jax", _jax_engine(jparams, name="j-ev")),
                             ("port", _engine(params, name="t-ev"))):
            events = []
            batch, _ = _closing(
                engine, lambda e: _preempt_once(e, events=events))
            got[side] = ([ev for ev, _ in events],
                         [sorted(at) for _, at in events],
                         batch.out_tokens)
        assert got["port"][:2] == got["jax"][:2]
        assert got["port"][0] == ["suspended", "resumed"]
        assert got["port"][2] == got["jax"][2] \
            == _ref(jparams, PROMPT, 24)

    def test_bf16_resumed_stream_matches_port_oracle(self, params):
        engine = _engine(params, "bfloat16", name="t16")
        batch, _ = _closing(engine, _preempt_once)
        assert batch.preemptions >= 1
        assert batch.out_tokens == t_gen.reference_greedy_decode(
            params, _tcfg("bfloat16"), PROMPT, 24)

    def test_resume_across_prefix_cache_hit(self, params, jparams):
        """Another request's cached prefix seeds the victim's admission;
        the suspension extends that lineage, and the resume still skips
        at least the victim's prompt."""
        engine = _engine(params)
        warm = list(PROMPT) * 3          # 18 tokens: 2 full blocks
        victim_prompt = list(PROMPT) * 2  # 12: hits warm's first block

        def run(e):
            e.generate(warm, max_tokens=2)
            return _preempt_once(e, prompt=victim_prompt, max_tokens=20)

        batch, _ = _closing(engine, run)
        assert batch.preemptions >= 1
        assert batch.out_tokens == _ref(jparams, victim_prompt, 20)
        assert batch.prefix_tokens_skipped >= len(victim_prompt)

    def test_resume_with_speculative_decoding_on(self, params, jparams):
        engine = _engine(params, draft_params=params,
                         draft_config=_tcfg(), spec_k=3)
        batch, inter = _closing(engine, _preempt_once)
        assert batch.preemptions >= 1
        assert batch.out_tokens == _ref(jparams, PROMPT, 24)
        assert inter.out_tokens == _ref(jparams, [4, 4, 8], 4)

    def test_three_preemptions_of_one_stream(self, params, jparams):
        """Three interactive bursts suspend the same batch stream three
        times; every resume re-extends the retained lineage."""
        engine = _engine(params)
        engine._step_sleep = 0.01
        try:
            batch = engine.submit(PROMPT, max_tokens=30,
                                  qos_class="batch")
            for burst in range(3):
                emitted = len(batch.out_tokens)
                _until(lambda: len(batch.out_tokens) >= emitted + 2,
                       "the batch stream stalled")
                engine.submit([40 + burst], max_tokens=2,
                              qos_class="interactive").result(
                                  timeout=LIMIT)
            engine._step_sleep = 0.0
            batch.result(timeout=LIMIT)
        finally:
            engine._step_sleep = 0.0
            engine.close()
        assert batch.preemptions == 3
        assert engine.stats["resumes"] == 3
        assert batch.out_tokens == _ref(jparams, PROMPT, 30)

    def test_chunked_resume_matches_jax(self, params, jparams):
        """No prefix cache and 8-token chunks: the resume re-prefills
        the whole extended prompt, in chunks, on both engines."""
        got = {}
        for side, engine in (
                ("jax", _jax_engine(jparams, name="j-ch", prefix_cache=False,
                                    prefill_chunk=8)),
                ("port", _engine(params, name="t-ch", prefix_cache=False,
                                 prefill_chunk=8))):
            events = []
            batch, inter = _closing(
                engine, lambda e: _preempt_once(e, events=events))
            sus = events[0][1]
            assert batch.preemptions == 1, side
            assert batch.prefix_tokens_skipped == 0, side
            assert batch.resume_prefill_tokens \
                == len(PROMPT) + sus["tokens"], side
            assert engine.stats["prefill_chunks"] \
                > engine.stats["prefills"], side
            got[side] = (batch.out_tokens, inter.out_tokens)
        assert got["port"] == got["jax"]
        assert got["port"][0] == _ref(jparams, PROMPT, 24)

    def test_int8_pool_resume_matches_jax_int8(self, params, jparams):
        """On an int8 pool the resume reads int8 prefix pages (K2-i8's
        plain version): the preempted stream equals JAX's uninterrupted
        int8 engine, apart from steps where that engine's top-2 logit
        gap is below 1e-3."""
        jeng = _jax_engine(jparams, name="j-i8", kv_dtype="int8",
                           prefix_cache=False, debug_logits=True)
        try:
            h = jeng.submit(PROMPT, max_tokens=24)
            want, _ = h.result(timeout=LIMIT)
            rows = h.logits
        finally:
            jeng.close()
        engine = _engine(params, name="t-i8", kv_dtype="int8")
        batch, _ = _closing(engine, _preempt_once)
        assert batch.preemptions >= 1
        assert batch.prefix_tokens_skipped >= len(PROMPT)
        got = batch.out_tokens
        n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if n is not None:
            top2 = np.sort(np.asarray(rows[n]))[-2:]
            assert top2[1] - top2[0] < 1e-3, (n, got, want)
        assert len(got) == 24


class TestPriorityAdmission:
    def test_higher_class_overtakes_queue(self, params):
        """1 slot, an un-preemptible batch stream holding it, and a
        queue of [batch, interactive]: the interactive request admits
        first although it arrived last."""
        engine = _engine(params)
        engine._step_sleep = 0.005
        try:
            head = engine.submit(PROMPT, max_tokens=8, qos_class="batch",
                                 preemptible=False)
            b2 = engine.submit([1, 2, 3], max_tokens=4, qos_class="batch")
            hi = engine.submit([9, 9], max_tokens=2,
                               qos_class="interactive")
            engine._step_sleep = 0.0
            for h in (head, b2, hi):
                h.result(timeout=LIMIT)
        finally:
            engine._step_sleep = 0.0
            engine.close()
        assert hi.admitted_w < b2.admitted_w
        assert engine.stats["preemptions"] == 0

    def test_interactive_not_preemptible_by_default(self, params):
        engine = _engine(params)
        try:
            h = engine.submit([1, 2], max_tokens=1, qos_class="interactive")
            assert h.preemptible is False
            h2 = engine.submit([1, 2], max_tokens=1)
            assert h2.qos_class == "standard" and h2.preemptible
            h.result(timeout=LIMIT)
            h2.result(timeout=LIMIT)
        finally:
            engine.close()

    def test_unknown_class_rejected_at_submit(self, params):
        engine = _engine(params)
        try:
            with pytest.raises(ValueError, match="unknown qos class"):
                engine.submit([1], max_tokens=1, qos_class="platinum")
        finally:
            engine.close()

    def test_fifo_mode_never_reorders_or_preempts(self, params):
        engine = _engine(params, preemption=False)
        engine._step_sleep = 0.005
        try:
            head = engine.submit(PROMPT, max_tokens=8, qos_class="batch")
            _until(lambda: head.out_tokens, "the head never decoded")
            b2 = engine.submit([1, 2, 3], max_tokens=2, qos_class="batch")
            hi = engine.submit([9, 9], max_tokens=2,
                               qos_class="interactive")
            engine._step_sleep = 0.0
            for h in (head, b2, hi):
                h.result(timeout=LIMIT)
        finally:
            engine._step_sleep = 0.0
            engine.close()
        assert engine.preemption is False
        assert head.preemptions == 0
        assert engine.stats["preemptions"] == 0
        assert b2.admitted_w < hi.admitted_w      # strict FIFO

    def test_the_ledger_names_the_class(self, params):
        ledger = qos_lib.TokenLedger({"acme": {"class": "interactive"},
                                      "crawler": {"class": "batch"}})
        engine = _engine(params, qos=ledger)
        try:
            hs = [engine.submit([1, 2], max_tokens=1, tenant=t)
                  for t in ("acme", "crawler", "stranger", None)]
            for h in hs:
                h.result(timeout=LIMIT)
        finally:
            engine.close()
        assert [h.qos_class for h in hs] == ["interactive", "batch",
                                             "standard", "standard"]
        assert [h.preemptible for h in hs] == [False, True, True, True]


class TestEngineBudget:
    def test_over_budget_tenant_defers_without_blocking_others(
            self, params):
        ledger = qos_lib.TokenLedger({"capped": {"rate": 1, "burst": 8}})
        engine = _engine(params, qos=ledger)
        try:
            first, _ = engine.generate([3, 3, 3], max_tokens=8,
                                       tenant="capped")
            assert len(first) == 8
            starved = engine.submit([3, 3, 3], max_tokens=8,
                                    tenant="capped")
            other = engine.submit([7, 7], max_tokens=2)
            # the un-budgeted tenant sails past the deferred one
            assert other.result(timeout=LIMIT)[1] == "length"
            assert starved.reason is None     # still waiting
            assert engine.stats["qos_deferrals"] >= 1
            ledger.buckets["capped"].credit(8)
            out, reason = starved.result(timeout=LIMIT)
            assert reason == "length" and len(out) == 8
        finally:
            engine.close()

    def test_resume_never_recharges_budget(self, params, jparams):
        """A preempted tenant prepaid its max_tokens at first admission;
        its bucket is empty by its resume, so a second charge would
        never let it back in."""
        ledger = qos_lib.TokenLedger(
            {"crawler": {"rate": 0.001, "burst": 24, "class": "batch"}})
        engine = _engine(params, qos=ledger)
        batch, _ = _closing(engine, _preempt_once)
        assert batch.preemptions >= 1
        assert batch.out_tokens == _ref(jparams, PROMPT, 24)
        assert engine.stats["qos_deferrals"] == 0


def _tenancy_run(engine):
    """The snapshot scenario: a batch stream, its slot row read while it
    decodes, then an interactive request that preempts it →
    (slot row, timeline, batch handle)."""
    engine._step_sleep = 0.01
    try:
        h = engine.submit(PROMPT, max_tokens=20, tenant="crawler",
                          qos_class="batch")
        _until(lambda: h.out_tokens, "the stream never decoded")
        row = engine.snapshot()["slot_detail"][0]
        engine.submit([4, 4], max_tokens=2,
                      qos_class="interactive").result(timeout=LIMIT)
        engine._step_sleep = 0.0
        h.result(timeout=LIMIT)
    finally:
        engine._step_sleep = 0.0
    return row, engine.timeline_view(), h


class TestObservability:
    def test_snapshot_and_timeline_carry_tenancy_as_jax(self, params,
                                                        jparams):
        got = {}
        for side, engine in (("jax", _jax_engine(jparams, name="j-obs")),
                             ("port", _engine(params, name="t-obs"))):
            got[side] = _closing(engine, _tenancy_run)
        row, timeline, h = got["port"]
        assert row["tenant"] == "crawler" and row["qos_class"] == "batch"
        assert row["preemptible"] is True
        events = [e["event"] for e in timeline]
        assert "suspended" in events and "resumed" in events
        sus = next(e for e in timeline if e["event"] == "suspended")
        assert sus["reason"] in ("slot", "blocks") and sus["tokens"] >= 1
        jrow, jtimeline, jh = got["jax"]
        assert set(row) == set(jrow)
        for key in ("tenant", "qos_class", "preemptible"):
            assert row[key] == jrow[key], key
        for name in ("suspended", "resumed"):
            mine = next(e for e in timeline if e["event"] == name)
            theirs = next(e for e in jtimeline if e["event"] == name)
            assert set(mine) == set(theirs), name
        assert h.out_tokens == jh.out_tokens

    def test_preemption_metrics_and_done_view_as_jax(self, params,
                                                     jparams):
        before = {k: t_metrics.REGISTRY._by_name[k].value(*lab)
                  for k, lab in (
                      ("serving_generate_preemptions_total", ("t-m", "slot")),
                      ("serving_generate_evictions_total",
                       ("t-m", "preempted")),
                      ("serving_qos_preemptions_total", ("crawler", "batch")),
                      ("serving_generate_resume_prefill_tokens_total",
                       ("t-m",)))}
        views = {}
        for side, engine in (("jax", _jax_engine(jparams, name="j-m")),
                             ("port", _engine(params, name="t-m"))):
            batch, inter = _closing(engine, _preempt_once)
            views[side] = (engine.qos_view(batch), engine.qos_view(inter),
                           batch)
        view, iview, batch = views["port"]
        assert view == {"tenant": "crawler", "class": "batch",
                        "preemptions": batch.preemptions,
                        "resume_prefill_tokens":
                            batch.resume_prefill_tokens}
        jview, jiview, _ = views["jax"]
        assert set(view) == set(jview)
        for key in ("tenant", "class", "preemptions"):
            assert view[key] == jview[key], key
        assert iview == jiview == {"tenant": "acme", "class": "interactive",
                                   "preemptions": 0,
                                   "resume_prefill_tokens": 0}
        reg = t_metrics.REGISTRY._by_name
        assert reg["serving_generate_preemptions_total"].value(
            "t-m", "slot") - before["serving_generate_preemptions_total"] \
            == batch.preemptions
        assert reg["serving_generate_evictions_total"].value(
            "t-m", "preempted") \
            - before["serving_generate_evictions_total"] == batch.preemptions
        assert reg["serving_qos_preemptions_total"].value(
            "crawler", "batch") - before["serving_qos_preemptions_total"] \
            >= batch.preemptions
        assert reg["serving_generate_resume_prefill_tokens_total"].value(
            "t-m") - before["serving_generate_resume_prefill_tokens_total"] \
            == batch.resume_prefill_tokens
        anon = _engine(params, name="t-anon")
        try:
            h = anon.submit([8, 8], max_tokens=1)
            h.result(timeout=LIMIT)
            assert anon.qos_view(h) is None
        finally:
            anon.close()

    def test_queued_tokens_count_a_resumes_emitted_tokens(self, params,
                                                          jparams):
        """At its suspension the victim waits with prompt + emitted
        tokens, the sequence its resume prefills, beside the 3-token
        interactive prompt that preempted it (``generate.py:1503``)."""
        gauge = t_metrics.REGISTRY._by_name[
            "serving_generate_queued_prompt_tokens"]
        seen = []

        def run(engine):
            return _preempt_once(engine, events=_Recorder(
                lambda at: seen.append(
                    (at["tokens"], engine.snapshot()["queued_tokens"],
                     gauge.value("t-q")))))

        batch, _ = _closing(_engine(params, name="t-q"), run)
        assert batch.out_tokens == _ref(jparams, PROMPT, 24)
        emitted, snap, booked = seen[0]
        assert snap == booked == 3 + len(PROMPT) + emitted


class _Recorder(list):
    """An events list that also calls ``fn(attrs)`` on ``suspended``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def append(self, item):
        if item[0] == "suspended":
            self.fn(item[1])
        super().append(item)


class TestTokenTelemetry:
    def test_token_times_one_stamp_a_token_in_order(self, params):
        engine = _engine(params, max_slots=2)
        try:
            specs = [([1, 2, 3], 10), ([4, 5], 3), ([6, 7, 8, 9], 6),
                     ([10, 11], 4)]
            handles = [engine.submit(p, max_tokens=m) for p, m in specs]
            for h, (_, m) in zip(handles, specs):
                toks, reason = h.result(timeout=LIMIT)
                assert reason == "length" and len(toks) == m
        finally:
            engine.close()
        for h in handles:
            assert len(h.token_times) == len(h.out_tokens)
            assert all(b >= a for a, b in zip(h.token_times,
                                              h.token_times[1:]))
            assert h.ttft_s is not None and h.ttft_s > 0
            assert len(h.itg_gaps) == len(h.out_tokens) - 1
        stats = engine.token_latency_stats()
        assert stats["ttft_count"] == 4
        assert stats["itg_count"] == sum(m - 1 for _, m in specs)

    def test_token_latency_stats_keys_and_percentiles_are_jaxs(
            self, params, jparams):
        rng = np.random.default_rng(7)
        ttft = rng.exponential(0.05, 37).tolist()
        itg = rng.exponential(0.01, 211).tolist()
        got = {}
        for side, engine in (("jax", _jax_engine(jparams, name="j-st")),
                             ("port", _engine(params, name="t-st"))):
            try:
                empty = engine.token_latency_stats()
                engine._ttft_samples.extend(ttft)
                engine._itg_samples.extend(itg)
                got[side] = (empty, engine.token_latency_stats())
            finally:
                engine.close()
        assert got["port"] == got["jax"]
        empty, full = got["port"]
        assert empty["ttft_p50_ms"] is None and empty["ttft_count"] == 0
        s = sorted(itg)
        assert full["itg_p99_ms"] == round(1000 * s[int(0.99 * len(s))], 3)
        assert full["itg_max_ms"] == round(1000 * s[-1], 3)

    def test_cancelled_before_first_token_has_no_ttft(self, params):
        engine = _engine(params)
        engine._step_sleep = 0.05
        try:
            blocker = engine.submit([1, 2, 3], max_tokens=20)
            _until(lambda: blocker.out_tokens, "the blocker never decoded")
            doomed = engine.submit([4, 5, 6], max_tokens=5,
                                   qos_class="batch")
            engine.cancel(doomed)
            doomed.wait(LIMIT)
            assert doomed.reason == "cancelled"
            assert doomed.ttft_s is None and doomed.token_times == []
        finally:
            engine._step_sleep = 0.0
        try:
            blocker.result(timeout=LIMIT)
        finally:
            engine.close()

    def test_the_qos_families_book_a_tenant_request(self, params):
        reg = t_metrics.REGISTRY._by_name
        key = ("tele-tenant", "interactive")
        tokens0 = reg["serving_qos_tokens_total"].value(*key)
        ttft0 = reg["serving_qos_ttft_seconds"].samples().get(
            key, {"count": 0})["count"]
        engine = _engine(params, name="t-tele")
        try:
            h = engine.submit([1, 2], max_tokens=5, tenant=key[0],
                              qos_class=key[1])
            h.result(timeout=LIMIT)
            anon = engine.submit([1, 2], max_tokens=3)
            anon.result(timeout=LIMIT)
        finally:
            engine.close()
        assert reg["serving_qos_tokens_total"].value(*key) - tokens0 == 5
        assert reg["serving_qos_ttft_seconds"].samples()[key]["count"] \
            - ttft0 == 1
        assert reg["serving_qos_inter_token_seconds"].samples()[key][
            "count"] >= 4
