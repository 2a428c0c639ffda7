"""Residency, version transitions, canaries and the int8 variant of the
port's unary plane against the JAX package's, over real sockets.

Each test runs ONE script of registrations, predicts and deploy calls
against a JAX ``ModelServer`` and a port ``ModelServer``
(``device="cpu"``) with the same weights (JAX's MLP init carried across
by ``params.tree_from_jax``; the int8 trees quantized on each side,
bit-identical codes) and the same byte budget, and reads back after
every step what an operator sees: ``/v1/models`` (budget, resident
bytes, RESIDENT/EVICTED, loads, evictions, ``@canary`` rows) and
``/v1/models/<name>`` (``residency``, ``canary``), which must be equal
on both, as must the status codes and ``X-Served-Version`` of every
predict (the canary split from a seeded ``_canary_rng``). Predictions
agree within atol 1e-6 / rtol 1e-5 (int8 within the same bounds of
JAX's int8, and within 0.05 of fp32 with 95 % top-1 agreement).
"""

import json
import random
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import quantize as j_quant
from kubeflow_tpu.compute import serving as j_serving
from kubeflow_tpu.compute.models import mlp as j_mlp
from kubeflow_tpu_torch.compute import quantize as t_quant
from kubeflow_tpu_torch.compute import serving as t_serving
from kubeflow_tpu_torch.compute.models import mlp as t_mlp
from kubeflow_tpu_torch.compute.params import tree_from_jax

SIDES = ("jax", "port")
CFG = dict(in_dim=64, hidden=512, n_classes=8)


def _params(seed):
    return jax.tree.map(np.asarray, j_mlp.init_params(
        j_mlp.Config(**CFG), jax.random.PRNGKey(seed)))


class Side:
    """One side's library, its model callables and its weight trees."""

    def __init__(self, side):
        self.side = side
        if side == "jax":
            self.lib = j_serving
            cfg = j_mlp.Config(**CFG)
            self.fn = lambda p, x: jax.nn.softmax(j_mlp.apply(p, x, cfg), -1)
            self.int8_fn = lambda qp, x: jax.nn.softmax(j_mlp.apply(
                j_quant.dequantize_tree(qp, jax.numpy.float32), x, cfg), -1)
        else:
            self.lib = t_serving
            cfg = t_mlp.Config(**CFG)
            self.fn = lambda p, x: torch.softmax(t_mlp.apply(p, x, cfg), -1)
            self.int8_fn = lambda qp, x: torch.softmax(t_mlp.apply(
                t_quant.dequantize_tree(qp, torch.float32), x, cfg), -1)

    def params(self, seed):
        p = _params(seed)
        return p if self.side == "jax" else tree_from_jax(p, device="cpu")

    def int8(self, seed):
        q = (j_quant if self.side == "jax" else t_quant).quantize_tree
        return q(self.params(seed))

    def server(self, budget):
        kw = {} if self.side == "jax" else {"device": "cpu"}
        server = self.lib.ModelServer(budget_bytes=budget, **kw)
        server._canary_rng = random.Random(0)   # a seeded split
        return server


def _one_bytes():
    return j_serving.tree_bytes(_params(1))


class Run:
    """One side's server, started, and what it answered."""

    def __init__(self, side, budget):
        self.s = Side(side)
        self.server = self.s.server(budget)
        self.port = None
        self.log = []

    def start(self):
        self.port = self.server.start(port=0, host="127.0.0.1")

    def predict(self, name, x):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/v1/models/{name}:predict",
            data=json.dumps({"instances": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            resp = urllib.request.urlopen(req)
        except urllib.error.HTTPError as e:
            self.log.append(("predict", name, e.code))
            return None
        out = np.asarray(json.load(resp)["predictions"])
        self.log.append(("predict", name, 200,
                         resp.headers["X-Served-Version"]))
        return out

    def get(self, path):
        body = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{self.port}{path}"))
        self.log.append(("get", path, body))
        return body


def _pair(budget):
    runs = {side: Run(side, budget) for side in SIDES}
    return runs


def _stop(runs):
    for r in runs.values():
        r.server.stop()


def _same_logs(runs):
    j, t = runs["jax"].log, runs["port"].log
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a == b, (a, b)


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_a_pair_thrashes_under_the_budget_alike():
    """Register a and b under a budget of 1.5 models; predict a, b, a:
    each predict evicts the other, and the evicted one reloads."""
    runs = _pair(int(_one_bytes() * 1.5))
    try:
        x = np.random.default_rng(0).standard_normal((2, 64)).astype(
            np.float32)
        outs = {}
        for r in runs.values():
            ma = r.server.register_loadable("a", r.s.fn, r.s.params(1))
            mb = r.server.register_loadable("b", r.s.fn, r.s.params(2))
            r.start()
            r.get("/v1/models")
            first = r.predict("a", x)
            r.get("/v1/models")
            r.get("/v1/models/a")
            r.predict("b", x)
            r.get("/v1/models")
            r.get("/v1/models/a")
            again = r.predict("a", x)
            r.get("/v1/models")
            _close(first, again)
            assert (ma.loads, ma.evictions, mb.evictions) == (2, 1, 1)
            outs[r.s.side] = first
        _same_logs(runs)
        _close(outs["port"], outs["jax"])
    finally:
        _stop(runs)


def test_an_int8_pair_stays_resident_where_fp32_would_not_fit():
    budget = int(_one_bytes() * 1.5)
    runs = _pair(budget)
    try:
        x = np.random.default_rng(1).standard_normal((4, 64)).astype(
            np.float32)
        outs = {}
        for r in runs.values():
            q1, q2 = r.s.int8(1), r.s.int8(2)
            assert r.s.lib.tree_bytes(q1) + r.s.lib.tree_bytes(q2) <= budget
            m1 = r.server.register_loadable("a8", r.s.int8_fn, q1)
            m2 = r.server.register_loadable("b8", r.s.int8_fn, q2)
            r.start()
            outs[r.s.side] = [r.predict(n, x) for n in ("a8", "b8", "a8")]
            r.get("/v1/models")
            assert m1.evictions == m2.evictions == 0
        _same_logs(runs)
        for got, want in zip(outs["port"], outs["jax"]):
            _close(got, want)
        listing = runs["port"].log[-1][2]
        assert {m["name"]: m["state"] for m in listing["models"]} \
            == {"a8": "RESIDENT", "b8": "RESIDENT"}
    finally:
        _stop(runs)


def test_int8_trees_count_and_serve_as_jaxs():
    """``tree_bytes`` of the int8 tree (codes + scales) equals JAX's and
    is under a third of fp32's; the int8 MLP's probabilities stay within
    0.05 of the fp32 model's with 95 % top-1 agreement, on both."""
    x = np.random.default_rng(2).standard_normal((32, 64)).astype(
        np.float32)
    sides = {s: Side(s) for s in SIDES}
    assert t_serving.tree_bytes(sides["port"].int8(1)) \
        == j_serving.tree_bytes(sides["jax"].int8(1))
    assert t_serving.tree_bytes(sides["port"].int8(1)) \
        < t_serving.tree_bytes(sides["port"].params(1)) / 3
    probs = {}
    for s, side in sides.items():
        kw = {} if s == "jax" else {"device": "cpu"}
        fp = side.lib.ServedModel("fp", make_fn=side.fn,
                                  host_params=side.params(1),
                                  batching=False, **kw)
        q = side.lib.ServedModel("q8", make_fn=side.int8_fn,
                                 host_params=side.int8(1),
                                 batching=False, **kw)
        probs[s] = (fp.predict_raw(x)[0], q.predict_raw(x)[0])
        ref, got = probs[s]
        assert (ref.argmax(-1) == got.argmax(-1)).mean() >= 0.95
        assert np.max(np.abs(ref - got)) < 0.05
    _close(probs["port"][1], probs["jax"][1])


def test_a_version_transition_preloads_then_flips_alike():
    runs = _pair(int(_one_bytes() * 2.5))
    try:
        x = np.random.default_rng(3).standard_normal((2, 64)).astype(
            np.float32)
        outs = {}
        for r in runs.values():
            m1 = r.server.register_loadable("m", r.s.fn, r.s.params(1),
                                            version=1, preload=True)
            r.start()
            v1 = r.predict("m", x)
            r.get("/v1/models")
            m2 = r.server.register_loadable("m", r.s.fn, r.s.params(2),
                                            version=2, preload=True)
            r.get("/v1/models")
            r.get("/v1/models/m")
            v2 = r.predict("m", x)
            assert not np.allclose(v1, v2)
            assert (m1.loads, m1.evictions, m1.loaded) == (1, 1, False)
            assert (m2.loads, m2.loaded) == (1, True)
            outs[r.s.side] = (v1, v2)
        _same_logs(runs)
        for got, want in zip(outs["port"], outs["jax"]):
            _close(got, want)
    finally:
        _stop(runs)


def test_model_over_budget_is_507_and_unmanaged_models_ignore_it():
    runs = _pair(int(_one_bytes() // 2))
    try:
        x = np.zeros((1, 64), np.float32)
        for r in runs.values():
            r.server.register_loadable("big", r.s.fn, r.s.params(1))
            p = r.s.params(2)
            r.server.register("free", lambda x, p=p, fn=r.s.fn: fn(p, x))
            r.start()
            r.predict("big", x)
            r.predict("free", x)
            r.get("/v1/models")
        _same_logs(runs)
        assert runs["port"].log[0] == ("predict", "big", 507)
    finally:
        _stop(runs)


def test_a_seeded_canary_splits_promotes_and_rolls_back_alike():
    runs = _pair(None)
    try:
        x = np.zeros((1, 64), np.float32)
        for r in runs.values():
            r.server.register_loadable("m", r.s.fn, r.s.params(1),
                                       version=1, preload=True)
            r.server.register_canary("m", r.s.fn, r.s.params(2),
                                     version=2, weight=0.5)
            r.start()
            for _ in range(24):
                r.predict("m", x)
            r.get("/v1/models")
            r.get("/v1/models/m")
            r.server.set_canary_weight("m", 0.0)
            for _ in range(4):
                r.predict("m", x)
            r.server.rollback_canary("m")
            r.get("/v1/models")
            r.server.register_canary("m", r.s.fn, r.s.params(3),
                                     version=3, weight=1.0)
            for _ in range(4):
                r.predict("m", x)
            assert r.server.promote_canary("m") is r.server.models()["m"]
            for _ in range(4):
                r.predict("m", x)
            r.get("/v1/models")
            r.get("/v1/models/m")
        _same_logs(runs)
        served = [e[3] for e in runs["port"].log if e[0] == "predict"]
        assert set(served[:24]) == {"1", "2"}
        assert set(served[24:28]) == {"1"} and set(served[28:]) == {"3"}
    finally:
        _stop(runs)


def test_a_canary_counts_toward_the_budget_and_cannot_evict_its_stable():
    for side in SIDES:
        s = Side(side)
        one = s.lib.tree_bytes(s.params(1))
        server = s.server(int(one * 2.5))
        server.register_loadable("m", s.fn, s.params(1), version=1,
                                 preload=True)
        before = server.resident_bytes()
        server.register_canary("m", s.fn, s.params(2), version=2,
                               weight=0.5)
        assert server.resident_bytes() == before + one
        server.rollback_canary("m")
        assert server.resident_bytes() == before
        server.stop()
        tight = s.server(int(one * 1.2))
        tight.register_loadable("m", s.fn, s.params(1), preload=True)
        with pytest.raises(s.lib.CapacityBusyError):
            tight.register_canary("m", s.fn, s.params(2), version=2,
                                  weight=0.5)
        assert "m" not in tight._canaries and tight.models()["m"].loaded
        with pytest.raises(KeyError):
            tight.register_canary("nope", s.fn, s.params(1), version=2)
        tight.stop()
