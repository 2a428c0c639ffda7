"""The port's ``:generate`` serving plane against the JAX package's, over
real sockets.

One JAX ``ModelServer`` with its engine and one port ``ModelServer``
with the port's engine (``device="cpu"``: the kernels' plain versions),
on the same fp32 weights carried across through numpy (the 2-layer
config of ``tests/test_serving_generate.py`` with GQA 4:2, one slot,
block 8), both on the same transport on port 0 (the wire suite runs
over the threaded and the async transport), get the same requests.
Streamed tokens must be identical to each other and to the JAX
cache-free oracle; status codes, error text, header names, the
mesh/prefix/QoS header values and the done frame's keys must match. A
stream preempted by an interactive tenant sends the same ``suspended``/
``resumed`` frames and the same done-frame ``qos`` view on both, with
``X-QoS-Class`` the class each side's tenant ledger names. The
KV-migration verbs: ``:prefill`` answers the same ``application/x-tensor``
framing, and a bundle from either server ``:attach``es on either, with
the oracle's tokens, ``X-KV-Bytes-Migrated`` and the same frames; a
bundle the pool cannot take (a prefill-role engine, an int8 bundle on a
float pool) or a malformed one answers the same 400.

A request's trace enters the ring after its response's last byte (the
threaded handler's ``finally``, the async loop's ``finish_cb``), so a
test that reads ``/debug/traces`` right after a response polls for it
(``_trace``).
"""

import dataclasses
import http.client
import json
import re
import time

import jax
import numpy as np
import pytest

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute import serving as j_serving
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu.qos import buckets as j_qos
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute import serving as t_serving
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax
from kubeflow_tpu_torch.qos import buckets as t_qos

CFG = jt.Config(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    max_seq=64, dtype="float32", attention="dense", remat=False,
    scan_layers=True)
TCFG = tt.Config(**{f.name: getattr(CFG, f.name)
                    for f in dataclasses.fields(tt.Config)})
SIDES = ("jax", "port")
# what a response head carries besides the server's own Date/Server
HEADERS = {"content-type", "transfer-encoding", "x-served-version",
           "x-prefix-tokens-skipped", "x-generate-mesh", "x-qos-class",
           "x-ttft-ms", "traceparent"}


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _engines(jparams, tparams):
    kw = dict(max_slots=1, block_size=8, max_context=64, name="lm")
    return {"jax": j_gen.GenerationEngine(jparams, CFG, **kw),
            "port": t_gen.GenerationEngine(tparams, TCFG, device="cpu",
                                           **kw)}


TRANSPORTS = ("threaded", "async")


def _start(engines, transport="threaded"):
    """→ {side: (server, engine, port)}, both sides on ``transport``"""
    out = {}
    for side, lib in (("jax", j_serving), ("port", t_serving)):
        server = lib.ModelServer()
        server.register_generator("lm", engines[side])
        out[side] = (server, engines[side],
                     server.start(port=0, host="127.0.0.1",
                                  transport=transport))
    return out


@pytest.fixture(scope="module", params=TRANSPORTS)
def served(jparams, tparams, request):
    pair = _start(_engines(jparams, tparams), request.param)
    yield pair
    for server, _, _ in pair.values():
        server.stop()


@pytest.fixture(params=TRANSPORTS)
def fresh(jparams, tparams, request):
    """A pair of servers for a test that drains them."""
    pair = _start(_engines(jparams, tparams), request.param)
    yield pair
    for server, _, _ in pair.values():
        server.stop()


def _post(port, body, headers=None, path="/v1/models/lm:generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    conn.request("POST", path, json.dumps(body).encode(), hdrs)
    return conn, conn.getresponse()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def _trace(port, trace_id, timeout=10.0):
    """The spans of trace ``trace_id`` from ``/debug/traces``, polled
    until the request's root span is in the ring (it enters after the
    response's last byte)."""
    deadline = time.monotonic() + timeout
    while True:
        traces = json.loads(_get(
            port, f"/debug/traces?trace_id={trace_id}")[1])["traces"]
        if any(s["name"].startswith("http ") for t in traces
               for s in t["spans"]) or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert traces, f"no trace {trace_id} in the ring after {timeout} s"
    return traces[0]["spans"]


def _frames(resp):
    return [json.loads(ln) for ln in resp.read().splitlines()
            if ln.strip()]


def _stream(port, body, headers=None):
    """→ (status, {lowercased header: value}, frames)"""
    conn, resp = _post(port, body, headers)
    head = {k.lower(): v for k, v in resp.getheaders()}
    frames = _frames(resp) if resp.status == 200 else json.loads(resp.read())
    conn.close()
    return resp.status, head, frames


@pytest.mark.parametrize("prompt,n", [([1, 2, 3], 6), ([5, 6, 7, 8, 9], 7),
                                      (list(range(10, 29)), 5)])
def test_streams_equal_jax_and_the_oracle(served, jparams, prompt, n):
    ref = j_gen.reference_greedy_decode(jparams, CFG, prompt, n)
    got = {}
    for side in SIDES:
        status, head, frames = _stream(served[side][2],
                                       {"tokens": prompt, "max_tokens": n})
        assert status == 200, (side, frames)
        assert head["content-type"] == "application/x-ndjson"
        assert HEADERS <= set(head), (side, head)
        toks = [f for f in frames if "token" in f]
        assert [f["token"] for f in toks] == ref, side
        assert [f["index"] for f in toks] == list(range(len(ref)))
        assert all(type(f["token"]) is int for f in toks)
        done = frames[-1]
        assert done["done"] and done["tokens"] == ref
        # the head's TTFT is the done frame's, exactly
        assert head["x-ttft-ms"] == repr(round(done["ttft_s"] * 1000, 3))
        got[side] = (head, done)
    (jh, jd), (th, td) = got["jax"], got["port"]
    assert set(jh) == set(th)
    for key in ("x-served-version", "x-prefix-tokens-skipped",
                "x-generate-mesh", "x-qos-class"):
        assert jh[key] == th[key], key
    assert set(jd) == set(td)
    for key in ("reason", "tokens", "prefix_tokens_skipped", "mesh",
                "attn_backend"):
        assert jd[key] == td[key], key


def test_prefix_hit_is_reported_alike(served, jparams):
    shared = list(range(30, 46))            # two full blocks of 8
    heads = {}
    for side in SIDES:
        port = served[side][2]
        assert _stream(port, {"tokens": shared + [1, 2],
                              "max_tokens": 3})[0] == 200
        status, head, frames = _stream(port, {"tokens": shared + [3],
                                              "max_tokens": 3})
        assert status == 200
        assert frames[-1]["prefix_tokens_skipped"] == 16
        assert frames[-1]["tokens"] == j_gen.reference_greedy_decode(
            jparams, CFG, shared + [3], 3)
        heads[side] = head["x-prefix-tokens-skipped"]
    assert heads == {"jax": "16", "port": "16"}


@pytest.mark.parametrize("body", [{"nope": 1}, {"tokens": []},
                                  {"tokens": [999]},
                                  {"tokens": [1], "max_tokens": 0},
                                  ["not-a-dict"], {"tokens": "abc"}],
                         ids=["no-tokens", "empty", "vocab", "budget",
                              "list", "string"])
def test_bad_bodies_answer_400_alike(served, body):
    answers = {side: _stream(served[side][2], body)[::2] for side in SIDES}
    assert answers["jax"][0] == 400
    assert answers["port"] == answers["jax"]


def test_unknown_engine_answers_404_alike(served):
    answers = {}
    for side in SIDES:
        conn, resp = _post(served[side][2], {"tokens": [1]},
                           path="/v1/models/ghost:generate")
        answers[side] = (resp.status, json.loads(resp.read()))
        conn.close()
    assert answers["jax"][0] == 404
    assert answers["port"] == answers["jax"]


def _slowed(pair, seconds):
    for _, engine, _ in pair.values():
        engine._step_sleep = seconds


def test_queued_deadline_answers_504_alike(served):
    answers = {}
    _slowed(served, 0.05)
    try:
        for side in SIDES:
            port = served[side][2]
            bconn, blocker = _post(port, {"tokens": [1, 2],
                                          "max_tokens": 30})
            assert blocker.status == 200     # the one slot is taken
            status, _, payload = _stream(
                port, {"tokens": [3, 4], "max_tokens": 5},
                {"X-Request-Deadline-Ms": "40"})
            blocker.read()
            bconn.close()
            answers[side] = (status,
                             re.sub(r"\d+ ms", "N ms", payload["error"]))
    finally:
        _slowed(served, 0.0)
    assert answers["jax"][0] == 504 and "deadline" in answers["jax"][1]
    assert answers["port"] == answers["jax"]


def test_deadline_mid_stream_ends_with_a_deadline_frame(served):
    dones = {}
    _slowed(served, 0.04)
    try:
        for side in SIDES:
            status, _, frames = _stream(
                served[side][2], {"tokens": [1, 2, 3], "max_tokens": 50},
                {"X-Request-Deadline-Ms": "250"})
            assert status == 200
            dones[side] = frames[-1]
    finally:
        _slowed(served, 0.0)
    for side, done in dones.items():
        assert done["reason"] == "deadline", side
        assert 0 < len(done["tokens"]) < 50
        assert "deadline expired mid-generation" in done["error"]
        assert served[side][1].occupancy() == 0
    assert set(dones["port"]) == set(dones["jax"])


def test_admin_drain_ends_streams_and_then_answers_503(fresh):
    answers = {}
    _slowed(fresh, 0.04)
    for side in SIDES:
        port = fresh[side][2]
        conn, resp = _post(port, {"tokens": [1, 2], "max_tokens": 60})
        assert resp.status == 200
        time.sleep(0.15)                      # a few tokens on the wire
        aconn, aresp = _post(port, {}, path="/admin/drain")
        assert (aresp.status, json.loads(aresp.read())) == (
            200, {"status": "draining"})
        aconn.close()
        done = _frames(resp)[-1]
        conn.close()
        assert done["reason"] == "draining" and done["tokens"], side
        status, head, payload = _stream(port, {"tokens": [5],
                                               "max_tokens": 2})
        answers[side] = (status, head.get("retry-after"), payload,
                         json.loads(_get(port, "/healthz")[1]))
    assert answers["jax"][:2] == (503, "1")
    assert "draining" in answers["jax"][2]["error"]
    assert answers["port"] == answers["jax"]


def test_keepalive_survives_a_stream(served):
    for side in SIDES:
        conn = http.client.HTTPConnection("127.0.0.1", served[side][2],
                                          timeout=60)
        conn.request("POST", "/v1/models/lm:generate",
                     json.dumps({"tokens": [4, 5],
                                 "max_tokens": 3}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        resp.read()
        conn.request("GET", "/v1/models/lm")     # the same socket
        resp = conn.getresponse()
        snap = json.loads(resp.read())["generator"]
        assert resp.status == 200, side
        assert snap["slots"] == 1 and snap["occupied"] == 0
        conn.close()


def test_health_and_model_listings_have_the_same_keys(served):
    bodies = {side: {path: json.loads(_get(served[side][2], path)[1])
                     for path in ("/healthz", "/v1/models",
                                  "/v1/models/lm")}
              for side in SIDES}
    j, t = bodies["jax"], bodies["port"]
    assert t["/healthz"] == j["/healthz"] == {"status": "ok"}
    assert set(t["/v1/models"]) == set(j["/v1/models"])
    assert [g["name"] for g in t["/v1/models"]["generators"]] == ["lm"]
    assert set(t["/v1/models"]["generators"][0]) \
        >= set(j["/v1/models"]["generators"][0])
    assert set(t["/v1/models/lm"]) == set(j["/v1/models/lm"])
    assert t["/v1/models/lm"]["model_version_status"] \
        == j["/v1/models/lm"]["model_version_status"]
    assert set(t["/v1/models/lm"]["generator"]) \
        >= set(j["/v1/models/lm"]["generator"])
    assert t["/v1/models/lm"]["generator"]["device"] == "cpu"
    assert _get(served["port"][2], "/v1/models/ghost")[0] == 404


def _families(port, prefix):
    text = _get(port, "/metrics")[1].decode()
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ") and ln.split()[2].startswith(prefix)}


#: the unary plane's families (JAX ``serving.py:61-113``)
UNARY_FAMILIES = {
    "serving_request_duration_seconds", "serving_batch_queue_wait_seconds",
    "serving_batch_size_rows", "serving_drain_timeout_total",
    "serving_decode_seconds", "serving_wire_format_total",
    "serving_batch_occupancy_requests", "serving_requests_total",
    "serving_deadline_exceeded_total"}


def test_metrics_hold_every_generate_family_of_jax(served):
    _stream(served["port"][2], {"tokens": [9, 8], "max_tokens": 2})
    want = _families(served["jax"][2], "serving_generate_")
    assert len(want) > 20
    assert want <= _families(served["port"][2], "serving_generate_")
    assert UNARY_FAMILIES <= _families(served["jax"][2], "serving_")
    assert UNARY_FAMILIES <= _families(served["port"][2], "serving_")
    text = _get(served["port"][2], "/metrics")[1].decode()
    assert re.search(r'^serving_generate_tokens_total\{model="lm"\} '
                     r'[1-9]', text, re.M)
    assert re.search(r'^serving_requests_total\{model="lm",code="200"\} '
                     r'[1-9]', text, re.M)


def test_request_trace_is_kept_and_continues_the_callers(served):
    tid = "ab" * 16
    status, head, _ = _stream(
        served["port"][2], {"tokens": [3, 3], "max_tokens": 2},
        {"traceparent": f"00-{tid}-{'cd' * 8}-01"})
    assert status == 200 and head["traceparent"].split("-")[1] == tid
    names = {s["name"] for s in _trace(served["port"][2], tid)}
    assert {"http POST /v1/models/lm:generate", "generate.queue_wait",
            "generate.prefill", "generate.decode"} <= names
    latency = json.loads(_get(served["port"][2],
                              "/debug/latency?path=:generate")[1])
    assert latency["requests"]["count"] >= 1


def test_a_disconnect_cancels_the_slot(served):
    _, engine, port = served["port"]
    engine._step_sleep = 0.05
    try:
        conn, resp = _post(port, {"tokens": [1, 2, 3], "max_tokens": 50})
        assert resp.status == 200
        resp.read1(64)
        conn.sock.close()
        conn.close()
        deadline = time.monotonic() + 20
        while engine.occupancy() and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        engine._step_sleep = 0.0
    assert engine.occupancy() == 0
    assert any(e["event"] == "evicted" and e["reason"] == "disconnect"
               for e in engine.timeline_view())


@pytest.mark.parametrize("verb", ["predict", "predictStream"])
def test_unary_verbs_on_a_generator_only_name_answer_404_alike(served,
                                                              verb):
    got = {}
    for side in SIDES:
        conn, resp = _post(served[side][2], {"instances": [[1.0]]},
                           path=f"/v1/models/lm:{verb}")
        got[side] = (resp.status, resp.read())
        conn.close()
    assert got["port"] == got["jax"] == (404,
                                         b'{"error": "model not found"}')


@pytest.mark.parametrize("transport", ["quic", "asyncio", "threads"])
def test_an_unknown_transport_is_refused_alike(transport):
    errors = {}
    for side, lib in (("jax", j_serving), ("port", t_serving)):
        with pytest.raises(ValueError) as err:
            lib.ModelServer().start(port=0, host="127.0.0.1",
                                    transport=transport)
        errors[side] = str(err.value)
    assert errors["port"] == errors["jax"] == (
        f"unknown serving transport {transport!r} (threaded | async)")


def test_the_router_relays_the_ports_stream_as_it_goes(served, jparams):
    from kubeflow_tpu.web import router as router_lib
    _, engine, port = served["port"]
    core = router_lib.RouterCore(health_interval=999)
    core.set_backends([f"127.0.0.1:{port}"])
    httpd = router_lib.create_app(core=core).serve(port=0,
                                                   host="127.0.0.1")
    engine._step_sleep = 0.05
    try:
        conn, resp = _post(httpd.server_address[1],
                           {"tokens": [1, 2, 3], "max_tokens": 20})
        assert resp.status == 200
        first = b""
        while b"\n" not in first:
            chunk = resp.read1(65536)
            assert chunk, "stream closed before the first frame"
            first += chunk
        # frame 1 came through while the engine still holds the slot
        assert engine.occupancy() == 1
        frames = [json.loads(ln) for ln in (first + resp.read()).splitlines()
                  if ln.strip()]
        conn.close()
    finally:
        engine._step_sleep = 0.0
        httpd.shutdown()
        core.stop()
    ref = j_gen.reference_greedy_decode(jparams, CFG, [1, 2, 3], 20)
    assert [f["token"] for f in frames if "token" in f] == ref
    assert frames[-1]["done"] and frames[-1]["tokens"] == ref


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_a_speculative_stream_matches_jax_frame_for_frame(jparams, tparams,
                                                        transport):
    """draft == target, k = 3: every verify round accepts all, so both
    engines emit the same bursts; one frame a token, contiguous indices,
    the same ``X-Spec-Acceptance`` and done-frame ``spec`` view."""
    kw = dict(max_slots=1, block_size=8, max_context=64, name="lm",
              spec_k=3)
    pair = _start({
        "jax": j_gen.GenerationEngine(jparams, CFG, draft_params=jparams,
                                      draft_config=CFG, **kw),
        "port": t_gen.GenerationEngine(tparams, TCFG, draft_params=tparams,
                                       draft_config=TCFG, device="cpu",
                                       **kw)}, transport)
    got = {}
    try:
        for side in SIDES:
            status, head, frames = _stream(pair[side][2],
                                           {"tokens": [1, 2, 3],
                                            "max_tokens": 10})
            assert status == 200
            toks = [f for f in frames if "token" in f]
            assert all(set(f) == {"token", "index"} for f in toks)
            assert [f["index"] for f in toks] == list(range(10))
            got[side] = (head, frames)
    finally:
        for server, _, _ in pair.values():
            server.stop()
    (jh, jf), (th, tf) = got["jax"], got["port"]
    assert set(th) == set(jh) and "x-spec-acceptance" in th
    assert th["x-spec-acceptance"] == jh["x-spec-acceptance"]
    assert tf[:-1] == jf[:-1]
    assert tf[-1]["tokens"] == jf[-1]["tokens"] \
        == j_gen.reference_greedy_decode(jparams, CFG, [1, 2, 3], 10)
    assert tf[-1]["spec"] == jf[-1]["spec"]


def _read_frames(resp, n_tokens):
    """Read a stream frame by frame until ``n_tokens`` token frames have
    come → those frames."""
    frames = []
    while sum("token" in f for f in frames) < n_tokens:
        line = resp.readline()
        assert line, "the stream ended early"
        if line.strip():
            frames.append(json.loads(line))
    return frames


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_a_preempted_stream_is_framed_as_jaxs(jparams, tparams, transport):
    """One slot, each side's engine with its own ledger built from the
    same spec: a ``crawler`` (batch) stream is preempted mid-stream by an
    ``acme`` (interactive) request and resumes. Both servers send the
    same frame sequence (token, event and done frames, their keys), the
    same done-frame ``qos`` views and ``X-QoS-Class`` values, and the
    oracle's tokens."""
    spec = {"acme": {"class": "interactive"}, "crawler": {"class": "batch"}}
    kw = dict(max_slots=1, block_size=8, max_context=64, name="lm")
    pair = _start({
        "jax": j_gen.GenerationEngine(jparams, CFG,
                                      qos=j_qos.TokenLedger(spec), **kw),
        "port": t_gen.GenerationEngine(tparams, TCFG, device="cpu",
                                       qos=t_qos.TokenLedger(spec), **kw)},
        transport)
    _slowed(pair, 0.02)
    got = {}
    try:
        for side in SIDES:
            port = pair[side][2]
            conn, resp = _post(port, {"tokens": [5, 9, 3, 7, 11, 2],
                                      "max_tokens": 24},
                               {"X-Tenant": "crawler"})
            assert resp.status == 200
            bhead = resp.getheader("X-QoS-Class")
            frames = _read_frames(resp, 5)
            status, ihead, iframes = _stream(port, {"tokens": [4, 4, 8],
                                                    "max_tokens": 4},
                                             {"X-Tenant": "acme"})
            assert status == 200
            frames += _frames(resp)
            conn.close()
            got[side] = (bhead, ihead["x-qos-class"], frames, iframes)
    finally:
        _slowed(pair, 0.0)
        for server, _, _ in pair.values():
            server.stop()
    ref = j_gen.reference_greedy_decode(jparams, CFG, [5, 9, 3, 7, 11, 2],
                                        24)
    shapes = {}
    for side, (bhead, ihead, frames, iframes) in got.items():
        assert (bhead, ihead) == ("batch", "interactive"), side
        toks = [f for f in frames if "token" in f]
        assert [f["token"] for f in toks] == ref, side
        assert [f["index"] for f in toks] == list(range(24)), side
        events = [f for f in frames if "event" in f]
        assert [e["event"] for e in events] == ["suspended", "resumed"]
        done = frames[-1]
        assert done["done"] and done["tokens"] == ref
        assert done["qos"]["preemptions"] == 1
        assert 0 < done["qos"]["resume_prefill_tokens"] <= 16
        assert iframes[-1]["qos"] == {"tenant": "acme",
                                      "class": "interactive",
                                      "preemptions": 0,
                                      "resume_prefill_tokens": 0}
        kinds = ["event" if "event" in f else "done" if "done" in f
                 else "token" for f in frames]
        shapes[side] = ([sorted(e) for e in events], sorted(done),
                        sorted(done["qos"]),
                        {k: done["qos"][k] for k in ("tenant", "class",
                                                     "preemptions")},
                        kinds[-1], kinds.count("event"))
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"][3] == {"tenant": "crawler", "class": "batch",
                                 "preemptions": 1}


BUNDLE_HEADERS = ("X-KV-Meta-Bytes", "X-Tensor-Dtype", "X-Tensor-Shape")


def _prefill(port, body, name="lm", headers=None):
    """``:prefill`` → (status, {lowercased header: value}, body bytes)"""
    conn, resp = _post(port, body, headers,
                       path=f"/v1/models/{name}:prefill")
    head = {k.lower(): v for k, v in resp.getheaders()}
    data = resp.read()
    conn.close()
    return resp.status, head, data


def _attach(port, framing, body, name="lm"):
    """``:attach`` of ``body`` with the bundle's ``framing`` headers →
    (status, head, frames or the error payload)"""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", f"/v1/models/{name}:attach", bytes(body),
                 {"Content-Type": "application/x-tensor", **framing})
    resp = conn.getresponse()
    head = {k.lower(): v for k, v in resp.getheaders()}
    out = _frames(resp) if resp.status == 200 else json.loads(resp.read())
    conn.close()
    return resp.status, head, out


def _framing(head):
    return {h: head[h.lower()] for h in BUNDLE_HEADERS}


def test_prefill_answers_jaxs_framing(served, jparams):
    prompt = [7, 1, 7, 2, 7, 3, 7, 4, 7, 5, 7]
    tid = "9a" * 16
    got = {}
    for side in SIDES:
        status, head, body = _prefill(
            served[side][2], {"tokens": prompt, "max_tokens": 5},
            headers={"traceparent": f"00-{tid}-{'34' * 8}-01"})
        assert status == 200, (side, body)
        assert head["content-type"] == "application/x-tensor"
        assert int(head["content-length"]) == len(body)
        bundle = j_serving.decode_kv_bundle(_framing(head), body)
        got[side] = (head, bundle["meta"])
    (jh, jm), (th, tm) = got["jax"], got["port"]
    assert set(th) == set(jh)
    for key in ("x-tensor-dtype", "x-tensor-shape", "x-served-version",
                "x-prefix-tokens-skipped"):
        assert th[key] == jh[key], key
    assert set(tm) == set(jm)
    for key in ("prompt", "first_token", "max_tokens", "n_blocks",
                "page_bytes", "scale_bytes", "kv_dtype"):
        assert tm[key] == jm[key], key
    assert tm["first_token"] == j_gen.reference_greedy_decode(
        jparams, CFG, prompt, 1)[0]
    spans = {sp["name"]: sp for sp in _trace(served["port"][2], tid)}
    assert spans["http POST /v1/models/lm:prefill"]
    assert spans["encode"]["attrs"]["format"] == "binary"
    assert spans["decode"]["attrs"]["format"] == "json"


@pytest.mark.parametrize("src", SIDES)
def test_a_bundle_attaches_on_either_server_alike(served, jparams, src):
    """One server's ``:prefill`` bundle, ``:attach``ed on both: the
    oracle's tokens, contiguous indices, the same head (with
    ``X-KV-Bytes-Migrated`` = the bundle's page + scale bytes) and the
    same done frame."""
    prompt = [11 + len(src), 3, 5, 8, 13, 21, 34, 55, 2, 4]
    status, head, body = _prefill(served[src][2],
                                  {"tokens": prompt, "max_tokens": 6})
    assert status == 200
    meta = j_serving.decode_kv_bundle(_framing(head), body)["meta"]
    ref = j_gen.reference_greedy_decode(jparams, CFG, prompt, 6)
    got = {}
    for side in SIDES:
        status, ahead, frames = _attach(served[side][2], _framing(head),
                                        body)
        assert status == 200, (side, frames)
        assert ahead["content-type"] == "application/x-ndjson"
        toks = [f for f in frames if "token" in f]
        assert [f["token"] for f in toks] == ref, side
        assert [f["index"] for f in toks] == list(range(6))
        assert frames[-1]["done"] and frames[-1]["tokens"] == ref
        assert ahead["x-kv-bytes-migrated"] == str(
            meta["page_bytes"] + meta["scale_bytes"])
        got[side] = (ahead, frames[-1])
    (jh, jd), (th, td) = got["jax"], got["port"]
    assert set(th) == set(jh) and "x-kv-bytes-migrated" in th
    for key in ("x-served-version", "x-prefix-tokens-skipped",
                "x-generate-mesh", "x-qos-class", "x-kv-bytes-migrated"):
        assert th[key] == jh[key], key
    assert set(td) == set(jd)
    for key in ("reason", "tokens", "prefix_tokens_skipped", "mesh"):
        assert td[key] == jd[key], key


def test_attach_records_its_read_and_binary_decode(served):
    status, head, body = _prefill(served["port"][2],
                                  {"tokens": [9, 9, 1], "max_tokens": 2})
    tid = "ef" * 16
    framing = {**_framing(head), "traceparent": f"00-{tid}-{'12' * 8}-01"}
    assert _attach(served["port"][2], framing, body)[0] == 200
    spans = {sp["name"]: sp for sp in _trace(served["port"][2], tid)}
    assert spans["decode"]["attrs"]["format"] == "binary"
    assert "http.read" in spans


def _bundle_body(engine, prompt, max_tokens=4):
    parts, framing, _ = t_serving.encode_kv_bundle(
        engine.prefill_export(prompt, max_tokens=max_tokens))
    return dict(framing), b"".join(bytes(p) for p in parts)


def _rejected(port, reason):
    text = _get(port, "/metrics")[1].decode()
    m = re.search(rf'^serving_kv_import_rejections_total\{{model="lm",'
                  rf'reason="{reason}"\}} (\S+)$', text, re.M)
    return float(m.group(1)) if m else 0.0


def test_an_int8_bundle_on_a_float_pool_answers_400_alike(served,
                                                          tparams):
    i8 = t_gen.GenerationEngine(tparams, TCFG, device="cpu", max_slots=1,
                                block_size=8, max_context=64,
                                kv_dtype="int8", name="i8")
    try:
        framing, body = _bundle_body(i8, [1, 2, 3, 4, 5])
    finally:
        i8.close()
    before = _rejected(served["port"][2], "dtype")
    answers = {side: _attach(served[side][2], framing, body)[::2]
               for side in SIDES}
    assert answers["jax"][0] == 400 and "dtype" in answers["jax"][1]["error"]
    assert answers["port"] == answers["jax"]
    assert _rejected(served["port"][2], "dtype") == before + 1


def test_a_prefill_role_server_refuses_attach_alike(jparams, tparams,
                                                    served):
    kw = dict(max_slots=1, block_size=8, max_context=64, name="lm",
              role="prefill")
    pair = _start({"jax": j_gen.GenerationEngine(jparams, CFG, **kw),
                   "port": t_gen.GenerationEngine(tparams, TCFG,
                                                  device="cpu", **kw)})
    try:
        status, head, body = _prefill(served["port"][2],
                                      {"tokens": [4, 2], "max_tokens": 3})
        assert status == 200
        answers = {side: _attach(pair[side][2], _framing(head), body)[::2]
                   for side in SIDES}
        # a prefill replica still exports
        assert _prefill(pair["port"][2], {"tokens": [4, 2]})[0] == 200
    finally:
        for server, _, _ in pair.values():
            server.stop()
    assert answers["jax"][0] == 400 and "role" in answers["jax"][1]["error"]
    assert answers["port"] == answers["jax"]


@pytest.mark.parametrize("defect", ["truncated", "trailing", "no-meta-bytes",
                                    "no-dtypes"])
def test_a_malformed_bundle_answers_400_alike(served, defect):
    status, head, body = _prefill(served["port"][2],
                                  {"tokens": [6, 5, 4], "max_tokens": 3})
    framing = _framing(head)
    if defect == "truncated":
        body = body[:-4]
    elif defect == "trailing":
        body = body + b"\0\0"
    else:
        del framing[{"no-meta-bytes": "X-KV-Meta-Bytes",
                     "no-dtypes": "X-Tensor-Dtype"}[defect]]
    answers = {side: _attach(served[side][2], framing, body)[::2]
               for side in SIDES}
    assert answers["jax"][0] == 400
    assert answers["jax"][1]["error"].startswith("bad request: ")
    assert answers["port"] == answers["jax"]


@pytest.mark.parametrize("body", [{"nope": 1}, {"tokens": []},
                                  {"tokens": [999]}, ["not-a-dict"],
                                  {"tokens": list(range(1, 60)) * 2}],
                         ids=["no-tokens", "empty", "vocab", "list",
                              "context"])
def test_bad_prefill_bodies_answer_400_alike(served, body):
    answers = {}
    for side in SIDES:
        status, _, data = _prefill(served[side][2], body)
        answers[side] = (status, json.loads(data))
    assert answers["jax"][0] == 400
    assert answers["port"] == answers["jax"]


@pytest.mark.parametrize("verb", ["prefill", "attach"])
def test_migration_verbs_on_an_unknown_engine_answer_404_alike(served,
                                                               verb):
    answers = {}
    for side in SIDES:
        conn, resp = _post(served[side][2], {"tokens": [1]},
                           path=f"/v1/models/ghost:{verb}")
        answers[side] = (resp.status, json.loads(resp.read()))
        conn.close()
    assert answers["jax"][0] == 404
    assert answers["port"] == answers["jax"]
