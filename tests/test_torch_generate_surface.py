"""The port engine's serving surface against the JAX engine's, in
process: admission policies, the deadline sweeps, ``close``,
``occupancy``, ``version``, the TTFT header and latency view, the QoS
view, ``snapshot()`` and the ``serving_generate_*`` booking.

Both engines run the 2-layer fp32 GQA config of
``tests/test_torch_serving_wire.py`` on the same weights (the port on
``device="cpu"``). A batch is queued whole under the engine's lock, so
admission sees every request at once on both sides.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute import serving as j_serving
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute import serving as t_serving
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax

CFG = jt.Config(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    max_seq=64, dtype="float32", attention="dense", remat=False,
    scan_layers=True)
TCFG = tt.Config(**{f.name: getattr(CFG, f.name)
                    for f in dataclasses.fields(tt.Config)})
BATCH = [([3, 9, 1, 22, 7], 6), ([5, 5, 44], 3), ([9] * 9, 5),
         ([2, 61, 30, 8], 2), ([1] * 11, 4)]
SIDES = ("jax", "port")


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture
def engines(jparams, tparams, request):
    """(jax engine, port engine) with ``request.param`` overrides; both
    closed after the test."""
    kw = dict(max_slots=1, block_size=8, max_context=64, name="surface")
    kw.update(getattr(request, "param", {}))
    pair = {"jax": j_gen.GenerationEngine(jparams, CFG, **kw),
            "port": t_gen.GenerationEngine(tparams, TCFG, device="cpu",
                                           **kw)}
    yield pair
    for eng in pair.values():
        eng.close()


def _queued_together(eng, batch, **kw):
    with eng._cond:          # the engine admits nothing until all are in
        return [eng.submit(p, max_tokens=m, **kw) for p, m in batch]


def _lifecycle(eng):
    return [(e["event"], e["request"], e.get("slot"))
            for e in eng.timeline_view()
            if e["event"] in ("admitted", "evicted")]


@pytest.mark.parametrize("engines", [{"max_slots": 2,
                                      "admission": "continuous"},
                                     {"max_slots": 2, "admission": "drain"}],
                         indirect=True, ids=["continuous", "drain"])
def test_admission_policy_gives_jax_tokens_and_order(engines, jparams):
    out, order = {}, {}
    for side, eng in engines.items():
        handles = _queued_together(eng, BATCH)
        out[side] = [h.result(timeout=120) for h in handles]
        order[side] = _lifecycle(eng)
    assert out["port"] == out["jax"]
    assert [t for t, _ in out["port"]] == [
        j_gen.reference_greedy_decode(jparams, CFG, p, m) for p, m in BATCH]
    assert order["port"] == order["jax"]
    assert [e[1] for e in order["port"] if e[0] == "admitted"] == [
        1, 2, 3, 4, 5]
    if engines["port"].admission == "drain":
        # an occupied batch admits nothing: every admission round starts
        # on an empty batch
        live = 0
        for event, _, _ in order["port"]:
            if event == "admitted":
                assert live == 0 or prev == "admitted"
                live += 1
            else:
                live -= 1
            prev = event


def test_unknown_admission_policy_is_refused(tparams):
    with pytest.raises(ValueError, match="admission"):
        t_gen.GenerationEngine(tparams, TCFG, admission="fifo",
                               device="cpu")


def test_deadline_sweeps_fail_queued_and_evict_active(engines):
    got = {}
    for side, eng in engines.items():
        errors = {"jax": j_serving, "port": t_serving}[side]
        eng._step_sleep = 0.03
        try:
            active = eng.submit([1, 2, 3], max_tokens=50,
                                deadline=time.monotonic() + 0.25)
            queued = eng.submit([4, 5], max_tokens=3,
                                deadline=time.monotonic() + 0.05)
            expired = eng.submit([6], max_tokens=3,
                                 deadline=time.monotonic() - 1)
            for h in (queued, expired):
                with pytest.raises(errors.DeadlineExceededError,
                                   match="while queued"):
                    h.result(timeout=60)
            assert active.wait(60)
        finally:
            eng._step_sleep = 0.0
        assert isinstance(active.error, errors.DeadlineExceededError)
        got[side] = (active.reason, queued.reason, expired.reason,
                     0 < len(active.out_tokens) < 50, queued.out_tokens,
                     eng.occupancy())
    assert got["jax"] == ("deadline", "deadline", "deadline", True, [], 0)
    assert got["port"] == got["jax"]


def test_the_engine_raises_the_serving_planes_errors():
    assert t_gen.DrainingError is t_serving.DrainingError
    assert t_gen.DeadlineExceededError is t_serving.DeadlineExceededError
    for err, code in ((t_serving.DrainingError("d"), 503),
                      (t_serving.DeadlineExceededError("d"), 504),
                      (ValueError("v"), 400), (RuntimeError("r"), 500)):
        assert t_serving.classify_predict_error(err)[0] == code
        assert j_serving.classify_predict_error(
            getattr(j_serving, type(err).__name__, type(err))("d"))[0] \
            == code


def test_close_occupancy_and_version(jparams, tparams):
    got = {}
    for side, eng in (
            ("jax", j_gen.GenerationEngine(
                jparams, CFG, max_slots=1, block_size=8, max_context=64,
                version=7, name="surface-close")),
            ("port", t_gen.GenerationEngine(
                tparams, TCFG, max_slots=1, block_size=8, max_context=64,
                version=7, name="surface-close", device="cpu"))):
        errors = {"jax": j_serving, "port": t_serving}[side]
        assert eng.version == 7 and eng.occupancy() == 0
        eng._step_sleep = 0.03
        h = eng.submit([1, 2, 3], max_tokens=50)
        deadline = time.monotonic() + 30
        while not h.out_tokens and time.monotonic() < deadline:
            time.sleep(0.01)
        occupied = eng.occupancy()
        eng.close(graceful=True)
        with pytest.raises(errors.DrainingError, match="draining"):
            eng.submit([1], max_tokens=1)
        got[side] = (occupied, h.reason, 0 < len(h.out_tokens) < 50,
                     eng.thread.is_alive(), eng.occupancy())
    assert got["jax"] == (1, "draining", True, False, 0)
    assert got["port"] == got["jax"]


def test_ttft_header_agrees_with_the_latency_view(engines):
    views = {}
    for side, eng in engines.items():
        h = eng.submit([7, 8, 9], max_tokens=5)
        h.result(timeout=60)
        view = eng.token_latency_view(h)
        header = eng.ttft_header(h)
        assert header == repr(round(view["ttft_s"] * 1000, 3))
        assert float(header) == round(view["ttft_s"] * 1000, 3)
        assert view["ttft_s"] == round(h.ttft_s, 6) > 0
        assert len(h.itg_gaps) == 4
        assert view["itg_max_s"] == round(max(h.itg_gaps), 6)
        dead = eng.submit([1], max_tokens=1, deadline=time.monotonic() - 1)
        dead.wait(60)
        assert eng.ttft_header(dead) is None
        assert eng.token_latency_view(dead) == {
            "ttft_s": None, "itg_p50_s": None, "itg_max_s": None}
        views[side] = set(view)
    assert views["port"] == views["jax"]


def test_snapshot_holds_every_key_of_jax(engines):
    snaps, details = {}, {}
    for side, eng in engines.items():
        eng._step_sleep = 0.03
        try:
            h = eng.submit([1, 2, 3], max_tokens=30,
                           deadline=time.monotonic() + 60, tenant="acme")
            deadline = time.monotonic() + 30
            while not h.out_tokens and time.monotonic() < deadline:
                time.sleep(0.01)
            snaps[side] = eng.snapshot()
            eng.cancel(h)
            assert h.wait(60) and h.reason == "cancelled"
        finally:
            eng._step_sleep = 0.0
        details[side] = next(d for d in snaps[side]["slot_detail"] if d)
    j, t = snaps["jax"], snaps["port"]
    assert set(t) >= set(j)
    assert set(t) - set(j) == {"device", "stats"}
    for key in ("prefix_cache", "migration"):
        assert set(t[key]) == set(j[key]), key
    assert t["mesh"] == j["mesh"]
    assert (t["role"], t["attn_backend"], t["slots"]) == (
        j["role"], j["attn_backend"], j["slots"])
    assert set(details["port"]) == set(details["jax"])
    assert details["port"]["tenant"] == "acme"
    assert {e["event"] for e in t["timeline"]} >= {"admitted", "prefill",
                                                    "first_token"}
    assert set(t["timeline"][0]) == set(j["timeline"][0])


def test_qos_view_is_none_for_an_anonymous_request(engines):
    views = {}
    for side, eng in engines.items():
        anon = eng.submit([1, 2], max_tokens=2)
        named = eng.submit([1, 2], max_tokens=2, tenant="acme",
                           qos_class="interactive")
        anon.result(timeout=60)
        named.result(timeout=60)
        with pytest.raises(ValueError, match="qos class"):
            eng.submit([1], max_tokens=1, qos_class="gold")
        views[side] = (eng.qos_view(anon), anon.qos_class,
                       eng.qos_view(named), named.preemptible)
    assert views["jax"] == (None, "standard",
                            {"tenant": "acme", "class": "interactive",
                             "preemptions": 0, "resume_prefill_tokens": 0},
                            False)
    assert views["port"] == views["jax"]


def test_mesh_and_spec_views_on_one_chip(engines):
    j, t = engines["jax"], engines["port"]
    assert t.mesh_view() == j.mesh_view()
    assert t.mesh_header() == j.mesh_header() == (
        f"tensor=1;per_chip_blocks={t.num_blocks}")
    assert t.attn_view() == j.attn_view() == "paged"
    assert t.spec_header() is None and j.spec_header() is None


def test_the_engine_books_its_generate_families(tparams):
    name = "surface-metrics"
    eng = t_gen.GenerationEngine(tparams, TCFG, max_slots=2, block_size=8,
                                 max_context=64, name=name, device="cpu")
    try:
        outs = [h.result(timeout=60) for h in _queued_together(eng, BATCH)]
        stats = dict(eng.stats)
    finally:
        eng.close()
    n = sum(len(t) for t, _ in outs)
    assert t_gen._TOKENS_TOTAL.value(name) == n == stats["tokens"]
    assert t_gen._EVICTIONS_TOTAL.value(name, "length") == len(BATCH)
    assert t_gen._PREFILL_CHUNKS_TOTAL.value(name) == stats["prefill_chunks"]
    assert t_gen._PREFIX_MISSES_TOTAL.value(name) == stats["prefix_misses"]
    assert t_gen._ATTN_BACKEND.value(name, "paged") == 1
    assert t_gen._ATTN_BACKEND.value(name, "gather") == 0
    assert t_gen._GEN_ROLE.value(name, "both") == 1
    assert t_gen._SHARD_MESH_DEVICES.value(name) == 1
    assert t_gen._QUEUED_PROMPT_TOKENS.value(name) == 0
    assert t_gen._TTFT_SECONDS.value(name) == len(BATCH)
    assert t_gen._EMITTED_TOKENS.value(name) == len(BATCH)
    assert t_gen._INTER_TOKEN_SECONDS.value(name) == n - len(BATCH)
    assert t_gen._QUEUE_WAIT_SECONDS.value(name, "admitted") == len(BATCH)
