"""The port's unary predict plane against the JAX package's, over real
sockets, and its batcher on its own.

One JAX ``ModelServer`` and one port ``ModelServer`` (``device="cpu"``)
serve the same models on the same transport, port 0 (the suite runs over
the threaded and the async transport; ``:predictStream`` only over the
threaded one, the async loop answers it 501):

- ``x2`` (``x * 2.0``): JSON ``instances`` (float and int bodies: the
  port casts float64/int64 to float32/int32 as JAX's x64-off ``jit``
  does), the b64 ``tensor`` and ``application/x-tensor`` over every
  ``TENSOR_DTYPES`` entry answer the same bytes and headers,
  ``X-Inference-Time-Ms`` and ``traceparent`` excepted;
- ``bf16`` (``x * 2.0`` rounded to bfloat16): the same bytes in all three
  formats (JAX's ``ml_dtypes.bfloat16`` rows, the port's widened fp32);
- ``mlp`` (the stock MLP's softmax, JAX weights carried across by
  ``params.tree_from_jax``) within atol 1e-6 / rtol 1e-5;
- ``resnet`` (a width-8 ResNet-18 in eval, as ``test_torch_resnet.py``
  builds it, its statistics perturbed; softmax) within 1e-5;
- ``big`` (managed, larger than the byte budget: 507) and ``tight`` (a
  stable copy plus an unloaded canary at weight 1 that cannot load
  beside it: 503 + Retry-After);

and every listed defect answers the same status on both, the same body
where the text is not a library's. ``:predictStream`` answers the same
frames, a truncated last line included. The batcher: coalescing,
``max_batch`` caps, the graceful swap and its straggler, a dead loop
failing fast, ``submit_async``. ``data.mnist`` reads the same arrays as
JAX's from an idx tree.
"""

import base64
import functools
import gzip
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import data as j_data
from kubeflow_tpu.compute import serving as j_serving
from kubeflow_tpu.compute.models import mlp as j_mlp
from kubeflow_tpu.compute.models import resnet as j_resnet
from kubeflow_tpu_torch.compute import data as t_data
from kubeflow_tpu_torch.compute import serving as t_serving
from kubeflow_tpu_torch.compute.models import mlp as t_mlp
from kubeflow_tpu_torch.compute.models import resnet as t_resnet
from kubeflow_tpu_torch.compute.params import (params_to_numpy,
                                               tree_from_jax)

SIDES = ("jax", "port")
MLP = dict(in_dim=16, hidden=8, n_classes=4)
RESNET = dict(depth=18, width=8, dtype="float32", n_classes=10)
# header values that differ per request or per process
VARYING = {"date", "server", "traceparent", "x-inference-time-ms"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mlp_params(seed, **cfg):
    return _np(j_mlp.init_params(j_mlp.Config(**(cfg or MLP)),
                                 jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _resnet_weights():
    """Numpy weights from the port's init (JAX's eager init of a
    ResNet-18 takes seconds), statistics perturbed from a seed."""
    params, stats = params_to_numpy(t_resnet.init_params(
        t_resnet.Config(**RESNET), torch.Generator().manual_seed(0),
        device="cpu"))
    rng = np.random.default_rng(3)
    stats = jax.tree.map(
        lambda a: (np.abs(a + 0.1 * rng.standard_normal(a.shape)) + 0.5)
        .astype(np.float32), stats)
    return params, stats


def _jax_server():
    cfg = j_mlp.Config(**MLP)
    params = _mlp_params(0)
    rcfg = j_resnet.Config(**RESNET)
    rparams, rstats = _resnet_weights()
    small = _mlp_params(1)
    server = j_serving.ModelServer(
        budget_bytes=int(1.5 * j_serving.tree_bytes(small)))
    server.register("x2", lambda x: x * 2.0)
    server.register("bf16", lambda x: (x * 2.0).astype(jnp.bfloat16))
    server.register("mlp", lambda x: jax.nn.softmax(
        j_mlp.apply(params, x, cfg), axis=-1))
    server.register("resnet", lambda x: jax.nn.softmax(j_resnet.apply(
        rparams, rstats, x, rcfg, train=False)[0], axis=-1))

    def fn(p, x):
        return jax.nn.softmax(j_mlp.apply(p, x, cfg), -1)

    server.register_loadable("big", fn, _mlp_params(2, in_dim=16,
                                                    hidden=64, n_classes=4))
    server.register_loadable("tight", fn, small, preload=True)
    server.register_canary("tight", fn, _mlp_params(3), version=2,
                           weight=1.0, preload=False)
    return server


def _port_server():
    cfg = t_mlp.Config(**MLP)
    params = tree_from_jax(_mlp_params(0), device="cpu")
    rcfg = t_resnet.Config(**RESNET)
    rparams, rstats = tree_from_jax(_resnet_weights(), device="cpu")
    small = tree_from_jax(_mlp_params(1), device="cpu")
    server = t_serving.ModelServer(
        budget_bytes=int(1.5 * t_serving.tree_bytes(small)), device="cpu")
    server.register("x2", lambda x: x * 2.0)
    server.register("bf16", lambda x: (x * 2.0).to(torch.bfloat16))
    server.register("mlp", lambda x: torch.softmax(
        t_mlp.apply(params, x, cfg), dim=-1))
    server.register("resnet", lambda x: torch.softmax(t_resnet.apply(
        rparams, rstats, x, rcfg, train=False)[0], dim=-1))

    def fn(p, x):
        return torch.softmax(t_mlp.apply(p, x, cfg), -1)

    big = tree_from_jax(_mlp_params(2, in_dim=16, hidden=64, n_classes=4),
                        device="cpu")
    server.register_loadable("big", fn, big)
    server.register_loadable("tight", fn, small, preload=True)
    server.register_canary("tight", fn,
                           tree_from_jax(_mlp_params(3), device="cpu"),
                           version=2, weight=1.0, preload=False)
    return server


@pytest.fixture(scope="module", params=["threaded", "async"])
def served(request):
    """→ {side: (server, port)}, both sides on the same transport"""
    out = {}
    for side, make in (("jax", _jax_server), ("port", _port_server)):
        server = make()
        out[side] = (server, server.start(port=0, host="127.0.0.1",
                                          transport=request.param))
    yield out
    for server, _ in out.values():
        server.stop()


def _post(port, path, body, headers=None):
    """→ (status, {lowercased header: value}, body bytes)"""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body, headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                data)
    finally:
        conn.close()


def _both(served, path, body, headers=None):
    return {side: _post(served[side][1], path, body, headers)
            for side in SIDES}


def _same_answer(got):
    (js, jh, jb), (ts, th, tb) = got["jax"], got["port"]
    assert ts == js, (got["port"], got["jax"])
    assert set(th) == set(jh)
    assert {k: v for k, v in th.items() if k not in VARYING} \
        == {k: v for k, v in jh.items() if k not in VARYING}
    assert tb == jb


def _json(obj):
    return json.dumps(obj).encode()


def _xtensor(x):
    return x.tobytes(), {"Content-Type": "application/x-tensor",
                         "X-Tensor-Dtype": x.dtype.name,
                         "X-Tensor-Shape": ",".join(map(str, x.shape))}


def _array(dtype, shape=(3, 5), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(0, 100, shape).astype(dtype)


@pytest.mark.parametrize("instances", [
    [[1.5, -2.25, 3.0], [0.1, 0.2, 0.3]],
    [[1, 2, 3], [4, 5, 6]],
    np.random.default_rng(1).standard_normal((9, 2, 3)).tolist(),
], ids=["floats", "ints", "nine-rows"])
def test_json_instances_answer_the_same_bytes(served, instances):
    _same_answer(_both(served, "/v1/models/x2:predict",
                       _json({"instances": instances}),
                       {"Content-Type": "application/json"}))


@pytest.mark.parametrize("dtype", sorted(t_serving.TENSOR_DTYPES))
def test_b64_tensors_answer_the_same_bytes(served, dtype):
    assert t_serving.TENSOR_DTYPES == j_serving.TENSOR_DTYPES
    x = _array(dtype)
    body = _json({"tensor": {"dtype": dtype, "shape": list(x.shape),
                             "b64": base64.b64encode(x.tobytes())
                             .decode()}})
    _same_answer(_both(served, "/v1/models/x2:predict", body))


@pytest.mark.parametrize("dtype", sorted(t_serving.TENSOR_DTYPES))
def test_x_tensor_bodies_answer_the_same_bytes(served, dtype):
    body, headers = _xtensor(_array(dtype, (2, 4, 3), seed=2))
    got = _both(served, "/v1/models/x2:predict", body, headers)
    _same_answer(got)
    assert got["port"][1]["content-type"] == "application/x-tensor"


@pytest.mark.parametrize("fmt", ["json", "b64", "binary"])
def test_bfloat16_outputs_answer_the_same_bytes(served, fmt):
    x = _array("float32", (2, 3), seed=4)
    if fmt == "json":
        body, headers = _json({"instances": x.tolist()}), None
    elif fmt == "b64":
        body, headers = _json({"tensor": {
            "dtype": "float32", "shape": [2, 3],
            "b64": base64.b64encode(x.tobytes()).decode()}}), None
    else:
        body, headers = _xtensor(x)
    _same_answer(_both(served, "/v1/models/bf16:predict", body, headers))


@pytest.mark.parametrize("fmt", ["json", "binary"])
def test_the_mlp_agrees_on_carried_weights(served, fmt):
    x = _array("float32", (5, 16), seed=5)
    if fmt == "json":
        got = _both(served, "/v1/models/mlp:predict",
                    _json({"instances": x.tolist()}))
        rows = {s: np.asarray(json.loads(got[s][2])["predictions"])
                for s in SIDES}
    else:
        got = _both(served, "/v1/models/mlp:predict", *_xtensor(x))
        rows = {s: np.frombuffer(got[s][2], "<f4").reshape(5, 4)
                for s in SIDES}
    assert got["port"][0] == got["jax"][0] == 200
    np.testing.assert_allclose(rows["port"], rows["jax"], atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(rows["port"].sum(-1), 1.0, atol=1e-6)


def test_a_width_8_resnet_agrees(served):
    x = np.random.default_rng(6).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    got = _both(served, "/v1/models/resnet:predict", *_xtensor(x))
    rows = {s: np.frombuffer(got[s][2], "<f4").reshape(2, 10)
            for s in SIDES}
    assert got["port"][0] == got["jax"][0] == 200
    np.testing.assert_allclose(rows["port"], rows["jax"], atol=1e-5)


XT = {"Content-Type": "application/x-tensor"}
DEFECTS = {
    "scalar": ("x2:predict", _json({"instances": 3}), None, 400),
    "ragged": ("x2:predict", _json({"instances": [[1, 2], [3]]}), None,
               400),
    "not-json": ("x2:predict", b"{nope", None, 400),
    "no-instances": ("x2:predict", _json({"inputs": [1]}), None, 400),
    "bad-b64": ("x2:predict", _json({"tensor": {
        "dtype": "float32", "shape": [1, 2], "b64": "!!!"}}), None, 400),
    "b64-dtype": ("x2:predict", _json({"tensor": {
        "dtype": "float64", "shape": [1], "b64": "AAAAAAAAAAA="}}), None,
        400),
    "b64-short": ("x2:predict", _json({"tensor": {
        "dtype": "float32", "shape": [2], "b64": "AAAAAA=="}}), None, 400),
    "x-tensor-dtype": ("x2:predict", b"\0" * 8, {
        **XT, "X-Tensor-Dtype": "float64", "X-Tensor-Shape": "1"}, 400),
    "x-tensor-shape": ("x2:predict", b"\0" * 8, {
        **XT, "X-Tensor-Dtype": "float32", "X-Tensor-Shape": "1,x"}, 400),
    "x-tensor-no-shape": ("x2:predict", b"\0" * 8, {
        **XT, "X-Tensor-Dtype": "float32"}, 400),
    "short-body": ("x2:predict", b"\0" * 8, {
        **XT, "X-Tensor-Dtype": "float32", "X-Tensor-Shape": "2,3"}, 400),
    "bad-deadline": ("x2:predict", _json({"instances": [[1.0]]}),
                     {"X-Request-Deadline-Ms": "soon"}, 400),
    "expired-deadline": ("x2:predict", _json({"instances": [[1.0]]}),
                         {"X-Request-Deadline-Ms": "0"}, 504),
    "feature-width": ("mlp:predict", _json({"instances": [[1.0] * 5]}),
                      None, 500),
    "over-budget": ("big:predict", _json({"instances": [[0.0] * 16]}),
                    None, 507),
    "busy": ("tight:predict", _json({"instances": [[0.0] * 16]}), None,
             503),
    "unknown-model": ("ghost:predict", _json({"instances": [[1.0]]}),
                      None, 404),
    "unknown-verb": ("x2:classify", _json({"instances": [[1.0]]}), None,
                     400),
}


@pytest.mark.parametrize("defect", sorted(DEFECTS))
def test_each_defect_answers_the_same_status(served, defect):
    target, body, headers, status = DEFECTS[defect]
    got = _both(served, f"/v1/models/{target}", body, headers)
    assert got["port"][0] == got["jax"][0] == status, got
    if status in (500, 504):
        # the library's error text (500), the measured wait (504)
        assert json.loads(got["port"][2])["error"]
    else:
        assert got["port"][2] == got["jax"][2]
    if status == 503:
        assert got["port"][1]["retry-after"] == "1" \
            == got["jax"][1]["retry-after"]


def _stream_body():
    b64 = base64.b64encode(np.float32([[7.5, 8.5]]).tobytes()).decode()
    lines = [{"instances": [[1.0, 2.0]]}, {"instances": [[3, 4]]},
             {"tensor": {"dtype": "float32", "shape": [1, 2], "b64": b64}},
             {"instances": [[1.0, 2.0, 3.0]]}, "not json",
             {"instances": 5}, {"instances": [[5.0, 6.0], [7.0, 8.0]]}]
    lines += [{"instances": [[float(i), 1.0]]} for i in range(40)]
    return b"\n".join(json.dumps(ln).encode() if not isinstance(ln, str)
                      else ln.encode() for ln in lines) + b"\n"


@pytest.mark.parametrize("served", ["threaded"], indirect=True)
@pytest.mark.parametrize("tail", [b"", b'{"instances": [[1.0, 2.0]]}',
                                  b'{"instan'],
                         ids=["newline", "unterminated", "truncated"])
def test_predict_stream_answers_the_same_frames(served, tail):
    got = _both(served, "/v1/models/x2:predictStream",
                _stream_body() + tail,
                {"Content-Type": "application/x-ndjson"})
    _same_answer(got)
    frames = [json.loads(ln) for ln in got["port"][2].splitlines()]
    assert len(frames) == 47 + bool(tail)
    if tail == b'{"instan':
        assert frames[-1]["error"].startswith("truncated body")


def test_served_model_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None is the card")
    with pytest.raises(RuntimeError, match="no silent fallback"):
        t_serving.ServedModel("card", lambda x: x)
    with pytest.raises(RuntimeError, match="no silent fallback"):
        t_serving.ModelServer().register("card", lambda x: x)


def test_a_dispatch_error_reaches_the_caller():
    def boom(x):
        raise RuntimeError("kernel refused")

    model = t_serving.ServedModel("boom", boom, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="kernel refused"):
            model.predict_raw(np.ones((1, 2), np.float32))
        code, payload, _ = t_serving.classify_predict_error(
            RuntimeError("kernel refused"))
        assert code == 500 and "kernel refused" in payload["error"]
    finally:
        model.close()


# ------------------------------------------------------------ batcher

def test_concurrent_http_requests_coalesce():
    server = t_serving.ModelServer(device="cpu")
    # 10 ms a call stands in for the device, so arrivals queue behind it
    server.register("cb", lambda x: (time.sleep(0.01), x * 2.0)[1])
    model = server.models()["cb"]
    port = server.start(port=0, host="127.0.0.1")
    try:
        x = np.random.default_rng(1).standard_normal(
            (1, 16)).astype(np.float32)
        body, headers = _xtensor(x)
        n, per = 8, 5
        results, errors = {}, []

        def client(i):
            try:
                c = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=30)
                for _ in range(per):
                    c.request("POST", "/v1/models/cb:predict", body,
                              headers)
                    r = c.getresponse()
                    data = r.read()
                    assert r.status == 200, data
                    results[i] = np.frombuffer(data, "<f4")
                c.close()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert len(results) == n
        for r in results.values():
            np.testing.assert_array_equal(r, x.ravel() * 2.0)
        assert model.device_calls < n * per, model.device_calls
        occ = t_serving._BATCH_OCCUPANCY.samples()[("cb", "stable")]
        assert occ["sum"] > occ["count"]      # mean occupancy > 1
    finally:
        server.stop()


def test_mixed_shapes_bucket_separately():
    model = t_serving.ServedModel("mix", lambda x: x + 1.0,
                                  batch_timeout_ms=20.0, device="cpu")
    try:
        outs, errors = {}, []

        def one(i):
            try:
                shape = (1, 4) if i % 2 else (1, 8)
                out, _ = model.predict_timed(
                    np.full(shape, float(i), np.float32))
                outs[i] = np.asarray(out)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        for i, out in outs.items():
            assert out.shape == ((1, 4) if i % 2 else (1, 8))
            np.testing.assert_allclose(out, float(i) + 1.0)
    finally:
        model.close()


def test_a_coalesced_group_never_exceeds_max_batch():
    dispatched = []

    def dispatch(x):
        dispatched.append(x.shape[0])
        return x * 2.0, x.shape[0]

    def finalize(fut, n):
        time.sleep(0.05)    # the device stays busy, so windows fill
        return np.asarray(fut)[:n]

    b = t_serving._Batcher(dispatch, finalize, max_batch=4, timeout_s=0.2)
    try:
        outs, errors = [], []

        def one():
            try:
                outs.append(b.submit(np.ones((3, 2), np.float32)))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        assert len(outs) == 6
        for out, _ms in outs:
            np.testing.assert_allclose(out, 2.0)
        assert dispatched and max(dispatched) <= 4, dispatched
    finally:
        b.stop()


def test_a_swap_drains_the_old_batcher_and_its_straggler_runs_direct():
    server = t_serving.ModelServer(device="cpu")
    server.register("vs", lambda x: x * 2.0)
    old = server.models()["vs"]
    seen = {}
    orig = old.close
    old.close = lambda graceful=False: (
        seen.update(graceful=graceful), orig(graceful))[-1]
    server.register("vs", lambda x: x * 3.0)   # traffic flipped
    assert seen == {"graceful": True}
    old._batcher.thread.join(timeout=5)        # the drain is done
    out, _ = old.predict_timed(np.ones((1, 2), np.float32))
    np.testing.assert_allclose(np.asarray(out), 2.0)  # the old model
    out, _ = server.models()["vs"].predict_timed(np.ones((1, 2), np.float32))
    np.testing.assert_allclose(np.asarray(out), 3.0)
    server.stop()
    with pytest.raises(RuntimeError, match="batcher stopped"):
        server.models()["vs"].predict_timed(np.ones((1, 2), np.float32))


def test_stop_closes_the_canary_batcher_thread():
    server = t_serving.ModelServer(device="cpu")

    def fn(p, x):
        return x * p["w"]

    server.register_loadable("c", fn, {"w": torch.tensor(2.0)},
                             preload=True)
    canary = server.register_canary("c", fn, {"w": torch.tensor(3.0)},
                                    version=2, weight=0.5)
    assert canary._batcher.thread.is_alive()
    server.stop()
    canary._batcher.thread.join(timeout=5)
    assert not canary._batcher.thread.is_alive()


def test_a_dead_loop_fails_the_next_submit_fast():
    model = t_serving.ServedModel("dead", lambda x: x, device="cpu")
    b = model._batcher
    try:
        def die(x):
            raise SystemExit("loop killed")

        b.dispatch = die
        with pytest.raises(SystemExit):
            b.submit(np.zeros((1, 2), np.float32))
        b.thread.join(timeout=5)
        assert not b.thread.is_alive() and b._dead.is_set()
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="stopped"):
            b.submit(np.zeros((1, 2), np.float32))
        assert time.perf_counter() - t0 < 0.4
    finally:
        model.close()


def test_a_late_submit_after_death_resolves():
    model = t_serving.ServedModel("late", lambda x: x, device="cpu")
    b = model._batcher
    model.close()
    b.thread.join(timeout=5)
    assert b._dead.is_set()
    done = threading.Event()
    slot = {"x": np.zeros((1, 2), np.float32), "done": done, "t": 0.0}
    b.q.put(slot)
    b._drain()
    assert done.is_set() and "error" in slot


def test_submit_async_fires_its_callback_once():
    model = t_serving.ServedModel("async", lambda x: x - 1.0, device="cpu")
    try:
        fired = []
        ready = threading.Event()

        def on_done(slot):
            fired.append(slot)
            ready.set()

        slot = model._batcher.submit_async(
            np.full((2, 3), 4.0, np.float32), on_done=on_done)
        assert ready.wait(10)
        assert fired == [slot] and slot["ms"] >= 0
        np.testing.assert_allclose(slot["out"], 3.0)
    finally:
        model.close()
    with pytest.raises(RuntimeError, match="batcher stopped"):
        model._batcher.submit_async(np.zeros((1, 1), np.float32))


def test_dispatch_pads_to_the_bucket_and_casts_as_jit_does():
    seen = []
    model = t_serving.ServedModel(
        "pad", lambda x: (seen.append((x.shape, x.dtype)), x)[1],
        batching=False, device="cpu")
    for rows, dtype in ((3, np.float64), (1, np.int64), (9, np.uint8)):
        out, _ = model.predict_raw(np.ones((rows, 2), dtype))
        assert out.shape == (rows, 2)
    assert seen == [((8, 2), torch.float32), ((1, 2), torch.int32),
                    ((16, 2), torch.uint8)]
    assert model.device_calls == 3


# ------------------------------------------------------------- mnist

def _idx(path, prefix, images, labels):
    with gzip.open(path / f"{prefix}-images-idx3-ubyte.gz", "wb") as f:
        f.write(b"\0" * 16 + images.tobytes())
    with gzip.open(path / f"{prefix}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(b"\0" * 8 + labels.tobytes())


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_reads_jaxs_arrays_from_an_idx_tree(tmp_path, split):
    rng = np.random.default_rng(7)
    prefix = "train" if split == "train" else "t10k"
    _idx(tmp_path, prefix,
         rng.integers(0, 256, (300, 28, 28), dtype=np.uint8),
         rng.integers(0, 10, 300, dtype=np.uint8))
    want = list(j_data.mnist(str(tmp_path), split))
    got = list(t_data.mnist(str(tmp_path), split))
    assert [b["image"].shape[0] for b in got] == [128, 128, 44]
    for g, w in zip(got, want, strict=True):
        for k in ("image", "label"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_mnist_without_a_tree_is_jaxs_synthetic_source(tmp_path):
    for path in (None, str(tmp_path / "absent")):
        g, w = next(t_data.mnist(path)), next(j_data.mnist(path))
        assert g["image"].shape == (128, 28, 28, 1)
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[k], w[k])
