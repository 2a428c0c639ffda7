"""Where the port's generation engine and async loop spend their
threads' time: the engine's phase counters (``stats``) and flight
recorder (``trace``), the async transport's loop counters and ring, the
``/debug/traces?engine=`` surface, the benchmark's readers of them
(``portbench/metrics/``), and the gap labeller of
``hack/engine_iteration_trace.py``.

CPU only, on a tiny fp32 TransformerLM (``device="cpu"``: the kernels'
plain versions)."""

import http.client
import importlib.util
import json
import pathlib
import re
import time
from types import SimpleNamespace

import pytest
import torch

from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute import serving as t_serving
from kubeflow_tpu_torch.compute import serving_async as t_async
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.obs import tracing
from portbench import harness

_HACK = pathlib.Path(__file__).resolve().parents[1] / "hack" \
    / "engine_iteration_trace.py"
_spec = importlib.util.spec_from_file_location("engine_iteration_trace",
                                               _HACK)
hack = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(hack)

CFG = tt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=64, dtype="float32",
                attention="dense", remat=False)
PROMPTS = [([3, 9, 1, 22, 7, 15, 2], 12), ([5, 5, 44], 4),
           ([9] * 17, 9), ([2, 61, 30, 8], 6), ([1] * 11, 5)]
#: the engine's parts of its thread's wall time
PARTS = hack.PARTS
ENGINE_SPANS = {"engine.admit", "engine.prefill", "engine.import",
                "engine.decode.prepare", "engine.decode.launch",
                "engine.decode.sync", "engine.decode.emit", "engine.wait"}


@pytest.fixture(scope="module")
def params():
    return tt.init_params(CFG, torch.Generator().manual_seed(0),
                          device="cpu")


def _engine(params, **kw):
    kw = {"max_slots": 2, "block_size": 8, "max_context": 64,
          "device": "cpu", **kw}
    return t_gen.GenerationEngine(params, CFG, **kw)


def _serve(eng):
    for h in [eng.submit(p, max_tokens=m) for p, m in PROMPTS]:
        h.result(timeout=60)


def test_decode_parts_sum_to_the_step(params):
    """The counters grow, and launch + sync is the step's elapsed time
    from the same stamps: the test knob's sleep stands for device time,
    so it falls in sync."""
    eng = _engine(params)
    eng._step_sleep = 0.002
    try:
        _serve(eng)
    finally:
        eng.close()
    st = eng.stats
    for p in PARTS:
        if p != "import":
            assert st[f"{p}_seconds_total"] > 0, p
    assert st["import_seconds_total"] == 0.0
    assert st["iterations"] >= st["decode_steps"] > 0
    assert st["admissions"] == len(PROMPTS)
    assert st["queue_wait_seconds_total"] > 0
    assert abs(st["decode_launch_seconds_total"]
               + st["decode_sync_seconds_total"]
               - st["decode_seconds_total"]) < 1e-9
    assert st["decode_sync_seconds_total"] >= st["decode_steps"] * 0.002


def test_parts_cover_the_engine_thread(params):
    """Admission, prefill, the decode step's four parts and the idle
    wait cover the engine thread's wall time to within 5 %: from its
    first span, the wait it starts with, to its end."""
    eng = _engine(params)
    try:
        _serve(eng)
        time.sleep(0.1)      # an idle stretch, booked as wait
        _serve(eng)
    finally:
        eng.close()
    first = eng.trace.records()[0]
    assert first[0] == "engine.wait"
    wall = time.time() - first[1]
    covered = sum(eng.stats[f"{p}_seconds_total"] for p in PARTS)
    assert not eng.thread.is_alive()
    assert 0.95 * wall <= covered <= wall
    assert eng.stats["idle_wait_seconds_total"] >= 0.1


def test_spans_are_named_nested_and_bounded(params, monkeypatch):
    """The ring holds the documented names on the engine thread's lane,
    a prefill inside the admission that ran it, a decode step's parts
    in order; it keeps its latest spans only."""
    eng = _engine(params)
    try:
        _serve(eng)
    finally:
        eng.close()
    recs = eng.trace.records()
    names = {r[0] for r in recs}
    assert names <= ENGINE_SPANS
    assert {"engine.admit", "engine.prefill", "engine.decode.launch",
            "engine.decode.sync", "engine.decode.emit"} <= names
    assert all(a <= b for _, a, b, _ in recs)
    by_id = {}
    for s in eng.trace.spans():
        by_id[s.span_id] = s
        assert s.thread == eng.thread.name
    prefills = [s for s in by_id.values() if s.name == "engine.prefill"]
    assert len(prefills) == len(PROMPTS)
    for s in prefills:
        parent = by_id[s.parent_id]
        assert parent.name == "engine.admit"
        assert parent.start <= s.start and s.end <= parent.end
        assert set(s.attrs) == {"prompt", "rows"}
        assert s.attrs["rows"] >= s.attrs["prompt"]
    steps = [r for r in recs if r[0].startswith("engine.decode.")]
    order = ["engine.decode.prepare", "engine.decode.launch",
             "engine.decode.sync", "engine.decode.emit"]
    assert [r[0] for r in steps[:4]] == order
    assert all(steps[i][2] <= steps[i + 1][1]
               for i in range(len(steps) - 1))
    assert steps[3][3]["rows"] >= 1
    monkeypatch.setattr(t_gen, "_ITERATION_SPANS", 16)
    small = _engine(params)
    try:
        _serve(small)
    finally:
        small.close()
    assert len(small.trace.records()) == 16
    assert small.trace.records()[-1][0] in ENGINE_SPANS


def test_trace_buffer_records_materialize_on_read():
    """Tuples in, ``Span``s out on read: parents by enclosure, one trace
    id for the ring, a window filter, the Chrome view."""
    ring = tracing.TraceBuffer(8, thread="lane")
    ring.record("outer", 10.0, 20.0)
    ring.record("inner", 11.0, 12.0, {"rows": 3})
    ring.record("next", 20.0, 21.0)
    assert [r[0] for r in ring.records(since=20.5)] == ["next"]
    assert [r[0] for r in ring.records(until=10.5)] == ["outer"]
    got = {s.name: s for s in ring.spans()}
    assert got["inner"].parent_id == got["outer"].span_id
    assert got["outer"].parent_id is None and got["next"].parent_id is None
    assert {s.trace_id for s in got.values()} == {ring.trace_id}
    assert got["inner"].to_dict()["attrs"] == {"rows": 3}
    assert got["inner"].to_dict()["duration_ms"] == 1000.0
    events = ring.chrome_trace()["traceEvents"]
    assert {e["tid"] for e in events} == {"lane"}
    assert [e["ts"] for e in events if e["name"] == "outer"] == [1e7]
    # the same ids on every read
    assert {s.span_id for s in ring.spans()} == {
        s.span_id for s in got.values()}


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("transport", ["async", "threaded"])
def test_loop_counters_and_engine_traces_route(params, transport):
    """A tiny ``:generate`` over each transport: the async loop books
    its busy time on ``/metrics`` (the threaded transport has no
    loop), and ``/debug/traces?engine=`` serves the engine's ring, plus
    the loop's on the async transport, in both views."""
    eng = _engine(params)
    server = t_serving.ModelServer(device="cpu")
    server.register_generator("tiny", eng)
    busy0 = t_async._LOOP_BUSY.value()
    port = server.start(port=0, host="127.0.0.1", transport=transport)
    try:
        code, body = _post(port, "/v1/models/tiny:generate",
                           {"tokens": [1, 2, 3], "max_tokens": 6})
        assert code == 200
        frames = [json.loads(x) for x in body.splitlines()]
        assert frames[-1]["done"] is True
        busy = t_async._LOOP_BUSY.value() - busy0
        now = time.monotonic()
        cap = SimpleNamespace(t0=now - 60, t1=now, offset_ns=time.time_ns()
                              - time.monotonic_ns())
        rings = hack.read_rings(SimpleNamespace(server=server,
                                                name="tiny"), cap)
        code, view = _get(port, "/debug/traces?engine=tiny")
        assert code == 200
        lanes = {}
        for t in view["traces"]:
            for sp in t["spans"]:
                lanes.setdefault(sp["thread"], set()).add(sp["name"])
        code, chrome = _get(port,
                            "/debug/traces?engine=tiny&format=chrome")
        assert code == 200
        assert _get(port, "/debug/traces?engine=none")[0] == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
        conn.close()
    finally:
        server.stop()
    assert lanes[eng.thread.name] >= {"engine.admit", "engine.prefill",
                                      "engine.decode.launch"}
    events = chrome["traceEvents"]
    assert all(e["ph"] == "X" for e in events)
    assert {e["name"] for e in events if e["tid"] == eng.thread.name} \
        <= ENGINE_SPANS
    assert {r[0] for r in rings[0]} >= {"engine.admit", "engine.prefill"}
    # a program without the rings reads as none
    assert hack.read_rings(SimpleNamespace(server=object(), name="tiny"),
                           cap) == ([], [])
    read = re.search(r"^serving_async_loop_busy_seconds_total (\S+)$",
                     metrics, re.M)
    assert read is not None
    if transport == "async":
        assert {r[0] for r in rings[1]} == {"http.loop"}
        assert busy > 0 and float(read.group(1)) >= busy
        assert lanes["serving-async-loop"] == {"http.loop"}
        assert any(e["tid"] == "serving-async-loop" for e in events)
    else:
        assert server._transport is None and rings[1] == []
        assert set(lanes) == {eng.thread.name}


# ------------------------------------------------ the benchmark's readers

def _stats(steps, spec=0, **secs):
    s = {"decode_steps": steps, "spec_rounds": spec, "iterations": 0,
         "admissions": 0}
    for p in PARTS:
        s[f"{p}_seconds_total"] = 0.0
    s["queue_wait_seconds_total"] = 0.0
    s.update(secs)
    return s


class _Run:
    def __init__(self, marks):
        """``marks``: the window's opening, each stretch's (before,
        after) and the close."""
        self.data = {"stats": (marks[0], marks[-1]),
                     "stretches": [tuple(marks[i:i + 2])
                                   for i in range(1, len(marks) - 1, 2)]}


READERS = {
    "decode_prepare_ms.serve": ("decode_steps",
                                "decode_prepare_seconds_total"),
    "decode_launch_ms.serve": ("decode_steps",
                               "decode_launch_seconds_total"),
    "decode_sync_ms.serve": ("decode_steps", "decode_sync_seconds_total"),
    "decode_emit_ms.serve": ("decode_steps", "decode_emit_seconds_total"),
    "admit_ms.serve": ("iterations", "admit_seconds_total"),
    "queue_wait_ms.serve": ("admissions", "queue_wait_seconds_total"),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_synthetic_stats(name):
    """Each reader: its seconds over its count across the window less
    the traced stretch, in ms; nothing where the count did not grow,
    where speculative rounds ran (the decode parts), or where the engine
    books no such counter (a program without them)."""
    count, key = READERS[name]
    read = harness.reader(name)

    def mark(n, s, spec=0):
        m = _stats(10 * n, spec, **{key: s})
        m[count] = 10 * n
        return m
    # untraced 0 → 2 and 5 → 7 (the stretch 2 → 5 left out)
    marks = [mark(0, 0.0), mark(2, 0.4), mark(5, 9.0), mark(7, 1.4 + 8.6)]
    assert read(_Run(marks), {}) == pytest.approx(
        (0.4 + 1.0) * 1e3 / 40)
    flat = [mark(1, 0.5)] * 4
    assert read(_Run(flat), {}) is None
    bare = [{k: v for k, v in m.items() if k != key} for m in marks]
    assert read(_Run(bare), {}) is None
    spec = [mark(0, 0.0), mark(2, 0.4), mark(5, 9.0),
            mark(7, 10.0, spec=3)]
    if count == "decode_steps":
        assert read(_Run(spec), {}) is None
    else:
        assert read(_Run(spec), {}) == pytest.approx(1.4e3 / 40)


#: the served cells, in the order they joined the benchmark
SERVED_CELLS = ["mistral-7b.docqa", "trinity-mini.docqa-long",
                "mistral-7b.docqa-repeat"]


def test_benchmark_entries_of_the_readers():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
            "ms", "program_counter", "gen_tokens_per_s", SERVED_CELLS)
        assert m["layer"] == entries["decode_step_ms.serve"]["layer"]


def test_decode_graph_pct_reader():
    """``decode_graph_pct.serve``: the replays' growth over the decode
    steps' across the window less the traced stretch, in %; nothing
    where no step ran, or where the engine books no replays."""
    read = harness.reader("decode_graph_pct.serve")

    def mark(steps, replays):
        return {"decode_steps": steps, "decode_graph_replays": replays}
    # untraced 0 → 1 and 2 → 3 (the stretch 1 → 2 left out)
    marks = [mark(1, 0), mark(41, 40), mark(71, 50), mark(131, 110)]
    assert read(_Run(marks), {}) == pytest.approx(100.0)
    marks[-1] = mark(131, 80)
    assert read(_Run(marks), {}) == pytest.approx(70.0)
    assert read(_Run([mark(5, 4)] * 4), {}) is None
    bare = [{"decode_steps": m["decode_steps"]} for m in marks]
    assert read(_Run(bare), {}) is None
    m = {e["name"]: e for e in harness.load_benchmark()["per_layer"]}
    entry = m["decode_graph_pct.serve"]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"],
            entry["workloads"], entry["layer"]) == (
        "%", "higher", "program_counter", "gen_tokens_per_s", SERVED_CELLS,
        m["decode_step_ms.serve"]["layer"])


def test_label_at_names_a_gap_by_program_spans():
    """A gap's midpoint (monotonic) is named by the engine's innermost
    span on the wall clock, with the loop beside it; without a covering
    engine span, the client's label."""
    offset_ns = 1_000 * 10 ** 9         # wall = monotonic + 1000 s
    engine = [("engine.admit", 1010.0, 1010.2, None),
              ("engine.prefill", 1010.05, 1010.15, {"prompt": 9}),
              ("engine.decode.launch", 1010.3, 1010.5, None)]
    loop = [("http.loop", 1010.4, 1010.45, {"events": 2})]
    label = hack.label_at(engine, loop, offset_ns,
                           lambda t: f"client@{t}")
    assert label(10.1) == "engine.prefill"
    assert label(10.01) == "engine.admit"
    assert label(10.35) == "engine.decode.launch"
    assert label(10.42) == "engine.decode.launch + http.loop"
    assert label(10.25) == "client@10.25"
    bare = hack.label_at([], [], offset_ns, lambda t: "client")
    assert bare(10.1) == "client"
