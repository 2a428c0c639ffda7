"""``python -m kubeflow_tpu_torch.cmd model-server``: a real subprocess
on the CPU (``GEN_DEVICE=cpu``, tiny ``GEN_*`` knobs, a ``QOS_TENANTS``
ledger) streams one request token-identically to the greedy oracles on
the weights the entry builds (its ``SEED``), names each tenant's
ledger class in ``X-QoS-Class`` and books its tokens under
``serving_qos_tokens_total``, and SIGTERM ends it with 0. In process:
each unary branch (the stock MLP from ``SEED``, ``MODEL_MODULE``,
``MODEL_DEVICE_MS``) serves ``:predict`` on ``GEN_DEVICE=cpu`` and
raises by name without it on a CUDA-less host; a stock-MLP subprocess
answers ``/healthz``, ``/v1/models/default`` and a predict whose rows
sum to 1, and SIGTERM ends it with 0; ``SERVING_TRANSPORT=async``
starts either branch on the event loop (the decode-role subprocess
below runs on it, names it in its log and exits 0 on SIGTERM);
``QOS_TENANTS``, ``GEN_PREEMPTION``, ``GEN_ROLE`` and the mesh knobs
(``GEN_MESH``, ``GEN_TP``, ``GEN_ROW_SHARD``, ``GEN_CALIBRATE``) reach the
engine as in the JAX entry, and without ``GEN_DEVICE`` a CUDA-less host
gets ``device.resolve``'s error, or, asked for a mesh, the card count's.
A second subprocess with ``GEN_ROLE=decode`` takes the first one's
``:prefill`` bundle on ``:attach`` and streams the oracle's continuation;
a third with ``GEN_TP=2`` serves the oracle's tokens over a 2-shard CPU
mesh under ``X-Generate-Mesh: tensor=2;...``."""

import http.client
import json
import os
import pathlib
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch import cmd
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
KNOBS = {"MODEL_GENERATE": "1", "GEN_DEVICE": "cpu", "PORT": "0",
         "HOST": "127.0.0.1", "GEN_VOCAB": "64", "GEN_D_MODEL": "32",
         "GEN_LAYERS": "2", "GEN_HEADS": "4", "GEN_MAX_CONTEXT": "64",
         "GEN_SLOTS": "2", "GEN_BLOCK_SIZE": "8", "GEN_PREFILL_CHUNK": "8",
         "OBS_EXPORT_DIR": ""}
TENANTS = ('{"acme": {"class": "interactive"}, '
           '"crawler": {"class": "batch", "rate": 1000}}')
UNSET = ("MODEL_GENERATE", "MODEL_MODULE", "MODEL_DEVICE_MS", "GEN_DEVICE",
         "GEN_MESH", "GEN_TP", "GEN_ROW_SHARD", "QOS_TENANTS", "GEN_ROLE",
         "GEN_CALIBRATE", "SERVING_TRANSPORT", "GEN_SPEC_K", "GEN_DRAFT",
         "GEN_PREEMPTION", "GEN_KV_DTYPE", "GEN_ADMISSION", "GEN_BLOCKS",
         "GEN_PREFIX_CACHE", "GEN_ATTN_BACKEND", "GEN_PREFILL_CHUNK")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in UNSET}
    env.update(KNOBS, PYTHONPATH=str(ROOT), **extra)
    return env


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def _serve(**extra):
    """A model-server subprocess → (the process, its port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.cmd", "model-server"],
        env=_env(**extra), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT)
    line = proc.stdout.readline()
    if not line.startswith("PORT "):
        proc.kill()
        raise AssertionError((line, proc.stderr.read()))
    return proc, int(line.split()[1])


def _stopped(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(30)


@pytest.fixture(scope="module")
def server():
    proc, port = _serve(QOS_TENANTS=TENANTS)
    try:
        yield proc, port
    finally:
        _stopped(proc)


@pytest.fixture(scope="module")
def decode_server():
    """The decode-role replica, on the async transport."""
    proc, port = _serve(GEN_ROLE="decode", SERVING_TRANSPORT="async")
    try:
        yield proc, port
    finally:
        _stopped(proc)


def _stock_weights():
    cfg = tt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                    max_seq=64, dtype="float32", attention="dense",
                    remat=False)
    params = tt.init_params(cfg, torch.Generator().manual_seed(cmd.SEED),
                            device="cpu")
    return cfg, params


@pytest.mark.parametrize("prompt,n", [([1, 2, 3], 8),
                                      (list(range(5, 25)), 6)],
                         ids=["short", "chunked"])
def test_a_stream_equals_the_oracles(server, prompt, n):
    _, port = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/models/default:generate",
                 json.dumps({"tokens": prompt, "max_tokens": n}).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    frames = [json.loads(ln) for ln in resp.read().splitlines() if ln]
    conn.close()
    cfg, params = _stock_weights()
    want = t_gen.reference_greedy_decode(params, cfg, prompt, n)
    jcfg = jt.Config(**{f: getattr(cfg, f) for f in (
        "vocab_size", "d_model", "n_layers", "n_heads", "max_seq", "dtype",
        "attention", "remat")})
    assert want == j_gen.reference_greedy_decode(
        jax.tree.map(np.asarray, params_to_numpy(params)), jcfg, prompt, n)
    assert [f["token"] for f in frames if "token" in f] == want
    assert frames[-1]["done"] and frames[-1]["tokens"] == want


def test_the_server_shows_its_device_and_chunks(server):
    _, port = server
    status, body = _get(port, "/healthz")
    assert (status, json.loads(body)) == (200, {"status": "ok"})
    snap = json.loads(_get(port, "/v1/models/default")[1])["generator"]
    assert snap["device"] == "cpu" and snap["prefill_chunk"] == 8
    assert snap["slots"] == 2 and snap["attn_backend"] == "paged"
    text = _get(port, "/metrics")[1].decode()
    assert "# TYPE serving_generate_tokens_total counter" in text


@pytest.mark.parametrize("tenant,cls", [("acme", "interactive"),
                                        ("crawler", "batch"),
                                        (None, "standard")])
def test_x_qos_class_is_the_ledgers(server, tenant, cls):
    _, port = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/models/default:generate",
                 json.dumps({"tokens": [1, 2, 3], "max_tokens": 3}).encode(),
                 {"Content-Type": "application/json",
                  **({"X-Tenant": tenant} if tenant else {})})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("X-QoS-Class") == cls
    done = [json.loads(ln) for ln in resp.read().splitlines() if ln][-1]
    conn.close()
    if tenant is None:
        assert "qos" not in done
        return
    assert done["qos"] == {"tenant": tenant, "class": cls,
                           "preemptions": 0, "resume_prefill_tokens": 0}
    text = _get(port, "/metrics")[1].decode()
    assert re.search(rf'^serving_qos_tokens_total\{{tenant="{tenant}",'
                     rf'class="{cls}"\}} [1-9]', text, re.M), text[-2000:]


def test_a_prefill_bundle_attaches_on_a_decode_role_server(server,
                                                         decode_server):
    """The two hops of a role-split fleet between two entry processes:
    ``:prefill`` on the first, its body and framing headers ``:attach``ed
    on the ``GEN_ROLE=decode`` one."""
    _, port = server
    _, dport = decode_server
    snap = json.loads(_get(dport, "/v1/models/default")[1])["generator"]
    assert snap["role"] == "decode"
    prompt = list(range(3, 16))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/models/default:prefill",
                 json.dumps({"tokens": prompt, "max_tokens": 5}).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    assert resp.status == 200, body
    framing = {h: resp.getheader(h) for h in (
        "X-KV-Meta-Bytes", "X-Tensor-Dtype", "X-Tensor-Shape")}
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", dport, timeout=60)
    conn.request("POST", "/v1/models/default:attach", body,
                 {"Content-Type": "application/x-tensor", **framing})
    resp = conn.getresponse()
    assert resp.status == 200
    assert int(resp.getheader("X-KV-Bytes-Migrated")) > 0
    frames = [json.loads(ln) for ln in resp.read().splitlines() if ln]
    conn.close()
    cfg, params = _stock_weights()
    want = t_gen.reference_greedy_decode(params, cfg, prompt, 5)
    assert [f["token"] for f in frames if "token" in f] == want
    snap = json.loads(_get(dport, "/v1/models/default")[1])["generator"]
    assert snap["migration"]["imports"] == 1 and snap["stats"][
        "prefills"] == 0


def test_the_async_decode_replica_names_its_transport_and_exits_zero(
        decode_server):
    proc, port = decode_server
    assert json.loads(_get(port, "/healthz")[1]) == {"status": "ok"}
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(30) == 0
    assert "(async transport)" in proc.stderr.read()


def test_sigterm_exits_zero(server):
    proc, port = server
    _get(port, "/healthz")
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(30) == 0


def test_without_gen_device_a_cuda_less_host_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: GEN_DEVICE unset is the card")
    env = _env()
    del env["GEN_DEVICE"]
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.cmd", "model-server"],
        env=env, capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and "PORT" not in out.stdout
    assert "no silent fallback" in out.stderr


@pytest.fixture
def knobs(monkeypatch):
    for k in UNSET:
        monkeypatch.delenv(k, raising=False)
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


@pytest.mark.parametrize("generate", [True, False],
                         ids=["generate", "unary"])
def test_serving_transport_async_builds_an_async_replica(knobs, generate):
    """``SERVING_TRANSPORT=async``, as the ModelDeployment controller
    renders it: either branch's replica starts on the event loop and
    answers."""
    from kubeflow_tpu_torch.compute import serving
    knobs.setenv("SERVING_TRANSPORT", "async")
    if generate:
        server = serving.ModelServer()
        server.register_generator("default", cmd.build_engine("default"))
    else:
        knobs.delenv("MODEL_GENERATE")
        server = cmd.build_unary_server("default")
    port = server.start(port=0, host="127.0.0.1")
    try:
        assert server.transport == "async"
        assert json.loads(_get(port, "/healthz")[1]) == {"status": "ok"}
        if generate:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/v1/models/default:generate",
                         json.dumps({"tokens": [1, 2, 3],
                                     "max_tokens": 4}).encode(),
                         {"Content-Type": "application/json"})
            frames = [json.loads(ln) for ln in
                      conn.getresponse().read().splitlines() if ln]
            conn.close()
            cfg, params = _stock_weights()
            assert frames[-1]["tokens"] == t_gen.reference_greedy_decode(
                params, cfg, [1, 2, 3], 4)
        else:
            x = np.random.default_rng(2).standard_normal((2, 64)).astype(
                np.float32)
            _, got = _unary_predict(port, "default", x.tolist())
            np.testing.assert_allclose(got, _stock_mlp(x), atol=1e-6)
    finally:
        server.stop()


@pytest.mark.parametrize("role", ["prefill", "decode", "both", None])
def test_gen_role_reaches_the_engine(knobs, role):
    if role is not None:
        knobs.setenv("GEN_ROLE", role)
    eng = cmd.build_engine(f"role-{role}")
    try:
        assert eng.role == (role or "both")
        assert eng.snapshot()["role"] == eng.role
    finally:
        eng.close()


@pytest.mark.parametrize("value", ["decoder", "PREFILL", "both,decode"])
def test_an_invalid_gen_role_exits_by_name(knobs, value):
    knobs.setenv("GEN_ROLE", value)
    with pytest.raises(SystemExit, match="GEN_ROLE") as err:
        cmd.model_server()
    assert value in str(err.value)


MODULE = """
import torch


def register(server):
    server.register("tripled", lambda x: x * 3.0, version=7)
"""


def _unary_predict(port, name, rows):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", f"/v1/models/{name}:predict",
                 json.dumps({"instances": rows}).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, body
    return resp.getheader("X-Served-Version"), np.asarray(
        body["predictions"])


def _stock_mlp(x):
    from kubeflow_tpu_torch.compute.models import mlp
    cfg = mlp.Config(in_dim=64, hidden=128, n_classes=16)
    params = mlp.init_params(cfg, torch.Generator().manual_seed(cmd.SEED),
                             device="cpu")
    return torch.softmax(mlp.apply(params, torch.tensor(x), cfg),
                         dim=-1).numpy()


@pytest.mark.parametrize("knob,value", [
    ("MODEL_GENERATE", None), ("MODEL_GENERATE", "0"),
    ("MODEL_MODULE", "served_by_module"), ("MODEL_DEVICE_MS", "5")])
def test_each_unary_branch_serves(knobs, tmp_path, knob, value):
    knobs.delenv("MODEL_GENERATE")
    if value is not None:
        knobs.setenv(knob, value)
    (tmp_path / "served_by_module.py").write_text(MODULE)
    knobs.syspath_prepend(str(tmp_path))
    server = cmd.build_unary_server("default")
    port = server.start(port=0, host="127.0.0.1")
    try:
        x = np.random.default_rng(0).standard_normal((3, 64)).astype(
            np.float32)
        if knob == "MODEL_MODULE":
            version, got = _unary_predict(port, "tripled", x.tolist())
            assert version == "7"
            np.testing.assert_allclose(got, x * 3.0, rtol=1e-6)
            return
        version, got = _unary_predict(port, "default", x.tolist())
        assert version == "1"
        if knob == "MODEL_DEVICE_MS":
            np.testing.assert_allclose(got, x * 2.0, rtol=1e-6)
            assert server.models()["default"].device_calls == 1
        else:
            assert got.shape == (3, 16)
            np.testing.assert_allclose(got, _stock_mlp(x), atol=1e-6)
    finally:
        server.stop()


@pytest.mark.parametrize("knob,value", [
    ("MODEL_GENERATE", None), ("MODEL_MODULE", "served_by_module"),
    ("MODEL_DEVICE_MS", "5")])
def test_a_unary_branch_without_gen_device_raises_on_a_cuda_less_host(
        knobs, knob, value):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: GEN_DEVICE unset is the card")
    knobs.delenv("MODEL_GENERATE")
    knobs.delenv("GEN_DEVICE")
    if value is not None:
        knobs.setenv(knob, value)
    with pytest.raises(RuntimeError, match="no silent fallback"):
        cmd.model_server()


def test_a_stock_mlp_replica_serves_and_stops_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.cmd", "model-server"],
        env=_env(MODEL_GENERATE=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("PORT "), (line, proc.stderr.read())
        port = int(line.split()[1])
        assert json.loads(_get(port, "/healthz")[1]) == {"status": "ok"}
        status = json.loads(_get(port, "/v1/models/default")[1])
        assert status["residency"]["managed"] is False
        assert "generator" not in status
        x = np.random.default_rng(1).standard_normal((2, 64)).astype(
            np.float32)
        _, got = _unary_predict(port, "default", x.tolist())
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(got, _stock_mlp(x), atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        _stopped(proc)


@pytest.mark.parametrize("value", ["0", "1"])
def test_gen_preemption_is_read_and_accepted(knobs, value):
    knobs.setenv("GEN_PREEMPTION", value)
    knobs.setenv("GEN_TP", "1")
    knobs.setenv("GEN_ROLE", "both")
    eng = cmd.build_engine("accepted")
    try:
        assert eng.preemption is (value == "1")
        assert eng.generate([1, 2], max_tokens=2)[1] == "length"
    finally:
        eng.close()


@pytest.mark.parametrize("spec,tenant,cls", [
    (TENANTS, "acme", "interactive"), (TENANTS, "crawler", "batch"),
    (TENANTS, "stranger", "standard"), ("", "acme", "standard")],
    ids=["interactive", "batch", "unlisted", "unset"])
def test_qos_tenants_gives_the_engine_its_ledger(knobs, spec, tenant, cls):
    knobs.setenv("QOS_TENANTS", spec)
    eng = cmd.build_engine("ledger")
    try:
        assert (eng._qos is None) == (not spec)
        h = eng.submit([1, 2], max_tokens=2, tenant=tenant)
        assert h.result(timeout=60)[1] == "length"
        assert h.qos_class == cls
    finally:
        eng.close()


def test_gen_device_unset_raises_the_no_fallback_error(knobs):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: GEN_DEVICE unset is the card")
    knobs.delenv("GEN_DEVICE")
    with pytest.raises(RuntimeError, match="no silent fallback"):
        cmd.model_server()


@pytest.mark.parametrize("env,tp", [
    ({"GEN_TP": "2"}, 2), ({"GEN_MESH": "tensor=4"}, 4),
    ({"GEN_MESH": "4", "GEN_TP": "2"}, 4), ({"GEN_TP": "1"}, 1),
    ({"GEN_MESH": "tensor=1", "GEN_TP": "2"}, 1)],
    ids=["tp", "mesh", "mesh-wins", "tp1", "mesh1-wins"])
def test_gen_mesh_and_gen_tp_shard_the_engine(knobs, env, tp):
    for k, v in env.items():
        knobs.setenv(k, v)
    eng = cmd.build_engine(f"mesh-{tp}")
    try:
        assert eng.tp == tp and (eng.mesh is None) == (tp == 1)
        assert eng.mesh_header() == (
            f"tensor={tp};per_chip_blocks={eng.per_chip_blocks}")
        cfg, params = _stock_weights()
        assert eng.generate([1, 2, 3], max_tokens=6)[0] \
            == t_gen.reference_greedy_decode(params, cfg, [1, 2, 3], 6)
    finally:
        eng.close()


def test_gen_row_shard_and_gen_calibrate_reach_the_engine(knobs):
    knobs.setenv("GEN_TP", "2")
    knobs.setenv("GEN_ROW_SHARD", "1")
    knobs.setenv("GEN_CALIBRATE", "yes")
    eng = cmd.build_engine("rowcal")
    try:
        assert eng.row_shard and eng.tp == 2
        assert 0.0 <= eng.stats["collective_share"] < 1.0
        assert round(t_gen._SHARD_COLLECTIVE_SHARE.value("rowcal"), 4) \
            == eng.stats["collective_share"]
    finally:
        eng.close()


def test_gen_row_shard_without_a_mesh_fails_by_name(knobs):
    knobs.setenv("GEN_ROW_SHARD", "1")
    with pytest.raises(ValueError, match="row_shard=True needs a mesh"):
        cmd.build_engine("row-nomesh")


def test_gen_tp_beyond_the_cards_exits_naming_the_count(knobs):
    if torch.cuda.device_count() >= 64:
        pytest.skip("this host has 64 cards")
    knobs.delenv("GEN_DEVICE")
    knobs.setenv("GEN_TP", "64")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(SystemExit, match="GEN_TP=64") as err:
        cmd.model_server()
    assert f"needs 64 CUDA cards, this host has {cards}" in str(err.value)


def test_a_gen_tp_server_streams_under_its_mesh_header():
    proc, port = _serve(GEN_TP="2")
    try:
        snap = json.loads(_get(port, "/v1/models/default")[1])["generator"]
        assert snap["mesh"]["tensor"] == 2 and snap["mesh"]["devices"] == 2
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/models/default:generate",
                     json.dumps({"tokens": [4, 5, 6],
                                 "max_tokens": 5}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("X-Generate-Mesh") == (
            f"tensor=2;per_chip_blocks={snap['mesh']['per_chip_blocks']}")
        frames = [json.loads(ln) for ln in resp.read().splitlines() if ln]
        conn.close()
        cfg, params = _stock_weights()
        want = t_gen.reference_greedy_decode(params, cfg, [4, 5, 6], 5)
        assert [f["token"] for f in frames if "token" in f] == want
        assert frames[-1]["mesh"] == snap["mesh"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        _stopped(proc)
