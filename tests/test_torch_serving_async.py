"""The port's async serving transport (``compute/serving_async.py``)
against the JAX package's, over raw sockets on 127.0.0.1, port 0.

One JAX ``ModelServer`` and one port ``ModelServer`` (``device="cpu"``)
on ``transport="async"`` serve the same models (``x2``: ``x * 2.0``,
batched; ``nb``: ``x + 1.0`` with ``batching=False``, run on the loop's
executor threads; the stock MLP on weights carried across, within 1e-6)
and get the same client bytes. The event-loop cases of JAX's
``TestAsyncTransport`` (``tests/test_serving_wire.py``), each side
answering alike: pipelined requests on one socket, a slow-loris that
stalls only its own connection, a soft drain mid-flight, a malformed
target costing one connection, ``:predictStream`` answered 501 with the
pointer, the zero-copy decode aliasing the request buffer. Besides: the
framing errors (400/411/413/431/501) with the same status and body, an
idle keep-alive reaped at a small ``idle_timeout``, the
``serving_transport_*`` families in ``/metrics`` and ``stop()`` leaving
no ``serving-async-*`` thread alive.
"""

import http.client
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import serving as j_serving
from kubeflow_tpu.compute.models import mlp as j_mlp
from kubeflow_tpu_torch.compute import serving as t_serving
from kubeflow_tpu_torch.compute import serving_async as t_async
from kubeflow_tpu_torch.compute.models import mlp as t_mlp
from kubeflow_tpu_torch.compute.params import tree_from_jax

SIDES = ("jax", "port")
MLP = dict(in_dim=16, hidden=8, n_classes=4)


def _mlp_params():
    return jax.tree.map(np.asarray, j_mlp.init_params(
        j_mlp.Config(**MLP), jax.random.PRNGKey(0)))


def _jax_server():
    cfg = j_mlp.Config(**MLP)
    params = _mlp_params()
    server = j_serving.ModelServer()
    server.register("x2", lambda x: x * 2.0)
    server.register("nb", lambda x: x + 1.0, batching=False)
    server.register("mlp", lambda x: jax.nn.softmax(
        j_mlp.apply(params, x, cfg), axis=-1))
    return server


def _port_server():
    cfg = t_mlp.Config(**MLP)
    params = tree_from_jax(_mlp_params(), device="cpu")
    server = t_serving.ModelServer(device="cpu")
    server.register("x2", lambda x: x * 2.0)
    server.register("nb", lambda x: x + 1.0, batching=False)
    server.register("mlp", lambda x: torch.softmax(
        t_mlp.apply(params, x, cfg), dim=-1))
    return server


def _start(server):
    return server, server.start(port=0, host="127.0.0.1", transport="async")


@pytest.fixture(scope="module")
def pair():
    """→ {side: (server, port)}"""
    out = {"jax": _start(_jax_server()), "port": _start(_port_server())}
    yield out
    for server, _ in out.values():
        server.stop()


def _x_request(name, x, verb="predict"):
    """One x-tensor request as raw socket bytes."""
    body = x.tobytes()
    head = (f"POST /v1/models/{name}:{verb} HTTP/1.1\r\n"
            f"Host: t\r\n"
            f"Content-Type: application/x-tensor\r\n"
            f"X-Tensor-Dtype: {x.dtype}\r\n"
            f"X-Tensor-Shape: {','.join(str(d) for d in x.shape)}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n")
    return head.encode() + body


class _Reader:
    """Reads length-framed responses off a raw socket, keeping what a
    recv brought past one response for the next (pipelining)."""

    def __init__(self, sock, timeout=30):
        self.sock = sock
        self.buf = b""
        sock.settimeout(timeout)

    def _fill(self):
        chunk = self.sock.recv(65536)
        self.buf += chunk
        return bool(chunk)

    def response(self):
        """→ (status, {lowercased header: value}, body, closed), where
        ``closed`` is whether the server closed the connection after."""
        while b"\r\n\r\n" not in self.buf:
            if not self._fill():
                return None, {}, self.buf, True
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        while len(self.buf) < length:
            if not self._fill():
                break
        body, self.buf = self.buf[:length], self.buf[length:]
        closed = headers.get("connection", "").lower() == "close"
        if closed:
            while self._fill():
                pass
        return status, headers, body, closed


def _raw(port, data, timeout=30):
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall(data)
        return _Reader(s, timeout).response()
    finally:
        s.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


# ------------------------------------------------ JAX's TestAsyncTransport

def test_pipelined_requests_one_socket(pair):
    """Three x-tensor predicts in ONE write: three 200s in order on the
    kept-alive socket, the same bytes from both servers."""
    x = np.random.default_rng(0).standard_normal((2, 16)).astype(np.float32)
    reqs = [_x_request("x2", x), _x_request("nb", x), _x_request("mlp", x)]
    got = {}
    for side in SIDES:
        s = socket.create_connection(("127.0.0.1", pair[side][1]),
                                     timeout=30)
        try:
            s.sendall(b"".join(reqs))
            reader = _Reader(s)
            got[side] = [reader.response() for _ in reqs]
        finally:
            s.close()
        for status, head, _, closed in got[side]:
            assert status == 200 and not closed, (side, head)
    for i in range(2):           # x2 and nb: exact arithmetic
        assert got["port"][i][2] == got["jax"][i][2]
    np.testing.assert_array_equal(
        np.frombuffer(got["port"][0][2], "<f4").reshape(2, 16), x * 2.0)
    np.testing.assert_array_equal(
        np.frombuffer(got["port"][1][2], "<f4").reshape(2, 16), x + 1.0)
    rows = {s: np.frombuffer(got[s][2][2], "<f4").reshape(2, 4)
            for s in SIDES}
    np.testing.assert_allclose(rows["port"], rows["jax"], atol=1e-6,
                               rtol=1e-5)


def test_slow_loris_does_not_block_other_connections(pair):
    x = np.zeros((1, 16), np.float32)
    for side in SIDES:
        port = pair[side][1]
        slow = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            # half a request head parks a buffer, not the loop
            slow.sendall(b"POST /v1/models/x2:predict HTTP/1.1\r\n"
                         b"Host: t\r\nContent-Ty")
            t0 = time.monotonic()
            status, _, _, _ = _raw(port, _x_request("x2", x))
            assert status == 200, side
            assert time.monotonic() - t0 < 10
            # the slow client can still finish its request
            body = x.tobytes()
            slow.sendall((f"pe: application/x-tensor\r\n"
                          f"X-Tensor-Dtype: float32\r\n"
                          f"X-Tensor-Shape: 1,16\r\n"
                          f"Content-Length: {len(body)}\r\n\r\n").encode()
                         + body)
            status, _, data, _ = _Reader(slow).response()
            assert status == 200, side
            assert data == (x * 2.0).tobytes()
        finally:
            slow.close()


def _slow_model(lib):
    """A model whose device call takes 0.5 s on a thread of its own, as
    JAX's drain test builds it."""

    class SlowModel(lib.ServedModel):
        def dispatch(self, x):
            x = np.asarray(x)
            done = threading.Event()
            box = {}

            def run():
                time.sleep(0.5)
                box["y"] = x * 2.0
                done.set()

            threading.Thread(target=run, daemon=True).start()
            return (done, box), x.shape[0]

        @staticmethod
        def finalize(fut, n):
            done, box = fut
            done.wait()
            return box["y"][:n]

    kw = {} if lib is j_serving else {"device": "cpu"}
    return SlowModel("slow", lambda x: x, **kw)


def test_drain_completes_inflight_soft():
    """Draining mid-request finishes the in-flight predict (200, then
    the connection closes), and health probes keep answering
    ``draining``: the same on both servers."""
    got = {}
    for side, lib in (("jax", j_serving), ("port", t_serving)):
        server = lib.ModelServer() if lib is j_serving \
            else lib.ModelServer(device="cpu")
        server._models["slow"] = _slow_model(lib)
        port = server.start(port=0, host="127.0.0.1", transport="async")
        try:
            x = np.ones((1, 4), np.float32)
            results = {}

            def inflight():
                results["resp"] = _raw(port, _x_request("slow", x))

            t = threading.Thread(target=inflight)
            t.start()
            time.sleep(0.15)          # the request is on the fake device
            admin = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=30)
            admin.request("POST", "/admin/drain", b"{}",
                          {"Content-Type": "application/json"})
            resp = admin.getresponse()
            drained = (resp.status, json.loads(resp.read()))
            admin.close()
            t.join(timeout=10)
            status, _, body, closed = results["resp"]
            probe = _get(port, "/healthz")
            got[side] = (drained, status, body, closed, probe)
        finally:
            server.stop()
    assert got["port"] == got["jax"]
    drained, status, body, closed, probe = got["port"]
    assert drained == (200, {"status": "draining"})
    assert status == 200 and closed
    np.testing.assert_array_equal(np.frombuffer(body, "<f4"), 2.0)
    assert probe == (200, b'{"status": "draining"}')


def test_malformed_target_costs_one_connection_not_the_loop(pair):
    got = {}
    for side in SIDES:
        port = pair[side][1]
        status, _, body, closed = _raw(
            port, b"GET http://[ HTTP/1.1\r\nHost: t\r\n\r\n")
        assert closed
        # the loop survived: a fresh connection still serves
        got[side] = (status, body, _get(port, "/healthz"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 400
    assert got["port"][2] == (200, b'{"status": "ok"}')


def test_predict_stream_answers_501_with_the_pointer(pair):
    got = {side: _raw(pair[side][1],
                      b"POST /v1/models/x2:predictStream HTTP/1.1\r\n"
                      b"Host: t\r\nContent-Type: application/x-ndjson\r\n"
                      b"Content-Length: 2\r\n\r\n{}")
           for side in SIDES}
    assert got["port"][0] == got["jax"][0] == 501
    assert got["port"][2] == got["jax"][2] == (
        b'{"error": "predictStream requires the threaded transport '
        b'(SERVING_TRANSPORT=threaded)"}')


def _buffer_of(a):
    """The object at the bottom of an array's base chain (through a
    memoryview to what it views)."""
    while isinstance(a, (np.ndarray, memoryview)):
        a = a.base if isinstance(a, np.ndarray) else a.obj
    return a


def test_zero_copy_decode_aliases_the_request_buffer():
    """The x-tensor body reaches the model as ``np.frombuffer`` over the
    transport's per-request ``bytearray``: no copy. The port's dispatch
    then uploads from it (pinned memory on a card)."""
    seen = {}
    for side, lib in (("jax", j_serving), ("port", t_serving)):

        class Capture(lib.ServedModel):
            def dispatch(self, x, side=side):
                seen[side] = x
                return np.asarray(x), x.shape[0]

        kw = {} if lib is j_serving else {"device": "cpu"}
        server = lib.ModelServer()
        server._models["zc"] = Capture("zc", lambda x: x, batching=False,
                                       **kw)
        port = server.start(port=0, host="127.0.0.1", transport="async")
        try:
            x = np.arange(8, dtype=np.float32).reshape(2, 4)
            status, _, body, _ = _raw(port, _x_request("zc", x))
            assert status == 200 and body == x.tobytes()
        finally:
            server.stop()
    for side in SIDES:
        got = seen[side]
        assert got.base is not None and not got.flags["OWNDATA"], side
        assert isinstance(_buffer_of(got), bytearray), side
    assert seen["port"].tobytes() == seen["jax"].tobytes()


# ----------------------------------------------------------- framing

DEFECTS = {
    "head-431": b"GET /healthz HTTP/1.1\r\nX-Big: " + b"a" * (33 * 1024),
    "chunked-411": b"POST /v1/models/x2:predict HTTP/1.1\r\nHost: t\r\n"
                   b"Transfer-Encoding: chunked\r\n\r\n2\r\n{}\r\n0\r\n\r\n",
    "gzip-501": b"POST /v1/models/x2:predict HTTP/1.1\r\nHost: t\r\n"
                b"Transfer-Encoding: gzip\r\n\r\n",
    "no-length-411": b"POST /v1/models/x2:predict HTTP/1.1\r\nHost: t\r\n"
                     b"Content-Type: application/json\r\n\r\n",
    "huge-413": b"POST /v1/models/x2:predict HTTP/1.1\r\nHost: t\r\n"
                b"Content-Length: 99999999999\r\n\r\n",
    "bad-length-400": b"POST /v1/models/x2:predict HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: ten\r\n\r\n",
    "request-line-400": b"NONSENSE\r\nHost: t\r\n\r\n",
    "method-501": b"DELETE /v1/models/x2 HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: 0\r\n\r\n",
    "short-body-400": _x_request("x2", np.zeros((2, 3), np.float32))
    .replace(b"X-Tensor-Shape: 2,3", b"X-Tensor-Shape: 2,4"),
    "generate-404": b"POST /v1/models/lm:generate HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: 2\r\n\r\n{}",
}


@pytest.mark.parametrize("defect", sorted(DEFECTS))
def test_a_framing_defect_answers_alike_and_closes(pair, defect):
    want = int(defect.rsplit("-", 1)[1])
    got = {side: _raw(pair[side][1], DEFECTS[defect]) for side in SIDES}
    for side in SIDES:
        status, head, _, closed = got[side]
        assert status == want and closed, (side, got[side])
        assert head["content-type"] == "application/json"
    assert got["port"][2] == got["jax"][2]


def test_an_idle_keepalive_is_reaped(pair):
    """A connection idle past ``idle_timeout`` between requests is
    closed by the loop's reaper (about once a second)."""
    closed_after = {}
    for side in SIDES:
        server, port = pair[side]
        server._transport.idle_timeout = 0.3
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=10)
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
            reader = _Reader(s, timeout=10)
            assert reader.response()[0] == 200
            t0 = time.monotonic()
            assert s.recv(1) == b""      # the server closed it
            closed_after[side] = time.monotonic() - t0
            s.close()
        finally:
            server._transport.idle_timeout = 60.0
    for side, secs in closed_after.items():
        assert 0.2 < secs < 5.0, (side, secs)


FAMILIES = ("serving_transport_open_connections",
            "serving_transport_read_stall_seconds",
            "serving_transport_write_stall_seconds")


def test_the_transport_families_are_in_metrics(pair):
    x = np.ones((1, 16), np.float32)
    assert _raw(pair["port"][1], _x_request("x2", x))[0] == 200
    kinds = {}
    for side in SIDES:
        text = _get(pair[side][1], "/metrics")[1].decode()
        kinds[side] = {ln.split()[2]: ln.split()[3]
                       for ln in text.splitlines()
                       if ln.startswith("# TYPE serving_transport_")}
        for fam in FAMILIES:
            series = "_count" if kinds[side].get(fam) == "histogram" else ""
            assert f'{fam}{series}{{transport="async"}}' in text, (side, fam)
    assert kinds["port"] == kinds["jax"] == {
        FAMILIES[0]: "gauge", FAMILIES[1]: "histogram",
        FAMILIES[2]: "histogram"}
    assert t_async.MAX_HEAD_BYTES == 32 * 1024


def _async_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("serving-async-")}


def test_stop_leaves_no_async_thread_alive():
    before = _async_threads()
    server = t_serving.ModelServer(device="cpu")
    server.register("nb", lambda x: x + 1.0, batching=False)
    server.register("x2", lambda x: x * 2.0)
    port = server.start(port=0, host="127.0.0.1", transport="async")
    assert server.transport == "async"
    mine = _async_threads() - before
    assert sorted(t.name for t in mine) == [
        "serving-async-exec-0", "serving-async-exec-1", "serving-async-loop"]
    x = np.ones((2, 3), np.float32)
    keep = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        for name in ("nb", "x2"):
            keep.sendall(_x_request(name, x))
            assert _Reader(keep).response()[0] == 200
        server.stop()
        assert not [t.name for t in mine if t.is_alive()]
        assert not server.models()["x2"]._batcher.thread.is_alive()
        # the loop closed the kept-alive connection on its way out
        keep.settimeout(10)
        assert keep.recv(1) == b""
    finally:
        keep.close()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
