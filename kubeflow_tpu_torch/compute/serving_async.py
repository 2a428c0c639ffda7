"""The async serving transport of the port: one ``selectors`` event
loop for every connection, zero-copy reads — the counterpart of
``kubeflow_tpu/compute/serving_async.py``, with the same names and the
same wire contract, byte for byte.

The threaded transport (``compute/serving.py``) pays a handler thread
per connection, blocking socket calls and body copies per request, and
its threads share the GIL with the eager forward and the engine's step.
This transport replaces them with a single loop thread:

- non-blocking accept/read/write; keep-alive connections multiplexed
  (an idle connection costs one selector entry, not a parked thread);
  pipelined requests on one socket answered in order;
- ``application/x-tensor`` bodies read by ``recv_into`` straight into a
  fresh ``bytearray`` per request and handed to the model as
  ``np.frombuffer`` over it (no copy on the host before the pinned
  upload); answers written as separate head and payload
  ``memoryview``s;
- ``:predict`` goes to the model's ``_Batcher`` through
  ``submit_async`` (dispatch and finalize stay on the batcher's thread);
  a ``batching=False`` model, and a straggler across a graceful version
  swap, run on two executor threads, never on the loop;
- ``:generate``, ``:prefill`` and ``:attach`` submit to the
  ``GenerationEngine`` with callbacks that only append to a completion
  deque and wake the loop: every device call stays on the engine's
  thread; a client that disconnects cancels its slot.

The wire contract is the threaded transport's: both route through
``serving.parse_predict_path`` / ``decode_json_predict`` /
``classify_predict_error`` / ``encode_predict_response`` /
``encode_kv_bundle`` / ``decode_kv_bundle`` / ``ModelServer.handle_get``
and ``web.http.framed_body_length``. ``:predictStream`` stays on the
threaded transport; this one answers it 501 with a pointer.
"""

import collections
import http.client
import json
import logging
import queue
import selectors
import socket
import threading
import time
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import tracing
from ..web.http import HTTPError, framed_body_length, parse_request_head
from . import serving

log = logging.getLogger("kubeflow_tpu_torch.serving.async")

_OPEN_CONNECTIONS = obs_metrics.REGISTRY.gauge(
    "serving_transport_open_connections",
    "Open client connections on the serving transport",
    ("transport",))
_READ_STALL = obs_metrics.REGISTRY.histogram(
    "serving_transport_read_stall_seconds",
    "Wall time from a request's first byte to its complete body — the "
    "transport's wait on the client's sends (a slow-loris shows up "
    "here, stalling its own connection only)",
    ("transport",),
    buckets=(1e-5, 1e-4, 1e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))
_WRITE_STALL = obs_metrics.REGISTRY.histogram(
    "serving_transport_write_stall_seconds",
    "Wall time from queueing a response to its last byte entering the "
    "socket — the transport's wait on the client's receive window",
    ("transport",),
    buckets=(1e-5, 1e-4, 1e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))
_LOOP_BUSY = obs_metrics.REGISTRY.counter(
    "serving_async_loop_busy_seconds_total",
    "Wall time the async transport's loop thread spent outside select() "
    "— its share of a second is the loop's hold on the interpreter, "
    "beside the generation engine's thread")

#: request heads larger than this are a client defect (431)
MAX_HEAD_BYTES = 32 * 1024
#: loop passes kept in the flight-recorder ring (``trace``)
_LOOP_SPANS = 16384


class _Conn:
    """One client connection's state machine. States:

    - ``head``: accumulating/awaiting request head bytes,
    - ``body``: reading the length-framed body (``recv_into`` a
      preallocated buffer on the tensor path),
    - ``wait``: request handed to the batcher/executor; READ interest
      dropped (kernel buffering backpressures pipelined requests),
    - ``write``: draining the response buffers.
    """

    __slots__ = ("sock", "buf", "state", "req", "rt", "out",
                 "close_after", "last_activity", "gen", "events",
                 "write_t0", "finish_cb")

    def __init__(self, sock):
        self.sock = sock
        self.buf = bytearray()
        self.state = "head"
        self.req = None           # current request record (dict)
        self.rt = None            # RequestTrace for the current POST
        self.out = collections.deque()   # memoryviews to flush
        self.close_after = False
        self.last_activity = time.monotonic()
        self.gen = 0              # bumps on close: stale completions drop
        self.events = 0           # currently-registered selector mask
        self.write_t0 = None
        self.finish_cb = None     # runs once the response is flushed


class AsyncTransport:
    """The event loop. One instance per ModelServer ``start()`` with
    ``transport="async"``; owns the listening socket, every client
    connection, and a tiny executor for direct (batcher-less) model
    calls."""

    def __init__(self, server, host="0.0.0.0", port=0,
                 idle_timeout=60.0):
        self.server = server
        self.idle_timeout = idle_timeout
        self.sel = selectors.DefaultSelector()
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind((host, port))
        self.lsock.listen(128)
        self.lsock.setblocking(False)
        self.port = self.lsock.getsockname()[1]
        # wakeup channel: batcher/executor threads poke the loop when a
        # completion lands (the loop may be parked in select())
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._completions = collections.deque()  # (conn, gen, outcome)
        self._conns = set()
        self._stop = False
        self._draining = False
        self._drain_applied = False
        self._last_reap = 0.0
        # direct-path executor: models with batching=False (and the
        # graceful-stop straggler fallback) run their blocking device
        # call here, never on the loop
        self._jobs = queue.Queue()
        self._job_threads = [
            threading.Thread(target=self._job_worker, daemon=True,
                             name=f"serving-async-exec-{i}")
            for i in range(2)]
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="serving-async-loop")
        # the loop's own time: wall seconds outside select(), and one
        # ``http.loop`` span a pass that did work
        self._busy = _LOOP_BUSY.labels()
        self.trace = tracing.TraceBuffer(_LOOP_SPANS,
                                         thread=self.thread.name)

    def start(self):
        self.sel.register(self.lsock, selectors.EVENT_READ, "listen")
        self.sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        for t in self._job_threads:
            t.start()
        self.thread.start()
        return self.port

    def drain(self):
        """Thread-safe SOFT drain: in-flight requests finish, every
        response closes its connection, and idle keep-alive
        connections are reaped once — but the listener stays open so
        health probes keep reaching ``/healthz`` (which now answers
        ``draining``; the router is the enforcement point that stops
        routing predicts here)."""
        self._draining = True
        self._wake()

    def stop(self):
        """Stop the loop (it closes the listener, the wake pair and
        every connection on its way out), then the executor threads,
        joined: a thread still inside torch when the interpreter exits
        aborts the process."""
        self._stop = True
        self._wake()
        self.thread.join(timeout=5)
        for _ in self._job_threads:
            self._jobs.put(None)
        for t in self._job_threads:
            t.join(timeout=30)

    def _wake(self):
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass    # a wake is already pending (or we're shut down)

    # ------------------------------------------------------- the loop

    def _loop(self):
        try:
            while not self._stop:
                events = self.sel.select(timeout=0.25)
                t0, t0w = time.perf_counter(), time.time()
                worked = bool(events or self._completions)
                for key, mask in events:
                    if key.data == "listen":
                        self._accept()
                    elif key.data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        conn = key.data
                        # per-connection guard: one defective client
                        # (or one bug in this state machine) must cost
                        # ONE connection, never the loop — the
                        # threaded transport confines failures to a
                        # worker thread, this confines them to a conn
                        try:
                            if mask & selectors.EVENT_WRITE:
                                self._on_writable(conn)
                            if mask & selectors.EVENT_READ \
                                    and conn.sock.fileno() >= 0:
                                self._on_readable(conn)
                        except Exception:  # noqa: BLE001 — keep loop
                            log.exception(
                                "async transport: connection handler "
                                "crashed; closing the connection")
                            self._close(conn)
                while self._completions:
                    conn, gen, outcome = self._completions.popleft()
                    if conn.gen == gen and conn.sock.fileno() >= 0:
                        try:
                            if outcome[0] in ("gtoken", "gevent",
                                              "gdone"):
                                self._gen_event(conn, outcome)
                            elif outcome[0] == "gexport":
                                self._complete_prefill(conn, outcome)
                            else:
                                self._complete_predict(conn, outcome)
                        except Exception:  # noqa: BLE001 — keep loop
                            log.exception(
                                "async transport: completion handler "
                                "crashed; closing the connection")
                            self._close(conn)
                    else:
                        # the client vanished while its request was on
                        # the device: the SLO source and the trace
                        # must still account the outcome (the threaded
                        # transport counts these in do_POST's finally)
                        self._account_abandoned(conn, outcome)
                if self._draining:
                    self._apply_drain()
                self._reap_idle()
                self._busy.inc(time.perf_counter() - t0)
                if worked:
                    self.trace.record("http.loop", t0w, time.time(),
                                      {"events": len(events)})
        finally:
            for conn in list(self._conns):
                self._close(conn)
            for sock in (self.lsock, self._wake_r, self._wake_w):
                try:
                    self.sel.unregister(sock)
                except (KeyError, ValueError):
                    pass
                sock.close()
            self.sel.close()

    def _accept(self):
        while True:
            try:
                sock, _addr = self.lsock.accept()
            except (BlockingIOError, OSError):
                return
            if self._stop:
                sock.close()
                continue
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock)
            self._conns.add(conn)
            _OPEN_CONNECTIONS.labels("async").inc()
            self._interest(conn, selectors.EVENT_READ)

    def _interest(self, conn, mask):
        if mask == conn.events:
            return
        if conn.events == 0 and mask:
            self.sel.register(conn.sock, mask, conn)
        elif mask == 0:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
        else:
            self.sel.modify(conn.sock, mask, conn)
        conn.events = mask

    def _close(self, conn):
        if conn not in self._conns:
            return
        self._conns.discard(conn)
        conn.gen += 1            # in-flight completions become stale
        req = conn.req
        if req is not None and req.get("gen_handle") is not None:
            # the stream's client went away: evict the decode slot so
            # an abandoned generation stops burning batch capacity
            try:
                req["gen_engine"].cancel(req["gen_handle"],
                                         reason="disconnect")
            except Exception:  # noqa: BLE001 — teardown bookkeeping
                log.exception("generation cancel on close failed")
        self._interest(conn, 0)
        try:
            conn.sock.close()
        except OSError:
            pass
        _OPEN_CONNECTIONS.labels("async").inc(-1)
        # a response that never finished flushing (peer reset, write
        # reap) still happened: run its bookkeeping (SLO count +
        # trace finish) instead of dropping it — the error-ratio SLO
        # must not undercount exactly when clients give up
        cb, conn.finish_cb = conn.finish_cb, None
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — teardown bookkeeping
                log.exception("async transport: close-time response "
                              "bookkeeping failed")

    def _account_abandoned(self, conn, outcome):
        """A completion whose connection already closed: count the
        would-have-been response into ``serving_requests_total`` and
        finish the request trace."""
        if outcome[0] in ("gtoken", "gevent"):
            return        # tokens/lifecycle frames after a dead
            #               stream: nothing to do
        if outcome[0] == "gdone" and conn.req is not None \
                and conn.req.get("gen_started"):
            return        # the stream's close-time finish_cb (set at
            #               _begin_stream) already accounted it
        rt, conn.rt = conn.rt, None
        conn.req = None
        if rt is None:
            return
        if outcome[0] == "ok":
            code = 200
        elif outcome[0] == "gexport":
            code = 200 if outcome[2] is None else \
                serving.classify_predict_error(outcome[2])[0]
        elif outcome[0] == "gdone":
            # never started streaming: account the would-have-been
            # taxonomy answer (200 is impossible — a token would have
            # started the stream)
            code = serving.classify_predict_error(
                outcome[3] if outcome[3] is not None
                else RuntimeError("generation ended"))[0]
        else:
            code = serving.classify_predict_error(outcome[1])[0]
        rt.attrs["code"] = code
        rt.attrs.setdefault("abandoned", True)
        if code >= 500:
            rt.status = "error"
        model = rt.attrs.get("model")
        if model is not None:
            serving._REQUESTS_TOTAL.labels(model, str(code)).inc()
        rt.finish()

    def _apply_drain(self):
        """One-shot at drain start: reap connections idling BETWEEN
        requests (anything mid-request finishes and closes after its
        response — the Connection: close header is added at
        response-build time). Later connections — health probes, late
        clients — are served normally and closed per response."""
        if self._drain_applied:
            return
        self._drain_applied = True
        now = time.monotonic()
        for conn in list(self._conns):
            # the grace window tells an idle keep-alive apart from a
            # client that CONNECTED while the drain wake was in
            # flight (state is "head" with no bytes either way):
            # resetting the latter RSTs a health probe racing the
            # drain. A reprieved true idler still closes with its
            # next response (close_after) or the periodic reap.
            if conn.state == "head" and not conn.out and not conn.buf \
                    and conn.req is None \
                    and now - conn.last_activity > 0.25:
                self._close(conn)

    def _reap_idle(self):
        # coarse timer: scanning every connection on every select()
        # return would be O(conns) on the hot loop for a 60s-grained
        # policy — once a second is plenty
        now = time.monotonic()
        if now - self._last_reap < 1.0:
            return
        self._last_reap = now
        for conn in list(self._conns):
            # head/body: slow-loris / silent peer. write: a client
            # that sent a request and never reads the response —
            # without reaping it the queued memoryviews pin the
            # result tensor forever. "wait" is excluded: that time
            # belongs to our own device, not the peer. "stream" is
            # reaped only with frames QUEUED and no send progress (a
            # client not consuming its tokens); an idle lull between
            # tokens belongs to our decode loop, not the peer.
            if conn.state in ("head", "body", "write") \
                    and now - conn.last_activity > self.idle_timeout:
                self._close(conn)
            elif conn.state == "stream" and conn.out \
                    and now - conn.last_activity > self.idle_timeout:
                self._close(conn)

    # ---------------------------------------------------------- reads

    def _on_readable(self, conn):
        conn.last_activity = time.monotonic()
        while True:
            req = conn.req
            if conn.state == "body" and req.get("tview") is not None:
                # zero-copy tensor path: straight into the
                # preallocated body buffer, no intermediate bytes
                try:
                    n = conn.sock.recv_into(
                        req["tview"][req["filled"]:])
                except (BlockingIOError, InterruptedError):
                    return
                except OSError:
                    self._close(conn)
                    return
                if n == 0:
                    self._close(conn)
                    return
                req["filled"] += n
                if req["filled"] >= req["length"]:
                    self._body_complete(conn)
                    if conn.state != "body":
                        return
                continue
            try:
                data = conn.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close(conn)
                return
            if not data:
                self._close(conn)
                return
            conn.buf += data
            self._advance(conn)
            if conn.state not in ("head", "body"):
                return           # backpressure: READ interest dropped

    def _advance(self, conn):
        """Parse as much of ``conn.buf`` as the state machine allows."""
        while True:
            if conn.state == "head":
                if not conn.buf:
                    return
                if conn.req is None:
                    conn.req = {"t0": time.monotonic(),
                                "t0w": time.time()}
                end = conn.buf.find(b"\r\n\r\n")
                if end < 0:
                    if len(conn.buf) > MAX_HEAD_BYTES:
                        self._error(conn, 431,
                                    "request head too large",
                                    discard=0)
                    return
                head = bytes(conn.buf[:end])
                del conn.buf[:end + 4]
                if not self._begin_request(conn, head):
                    return
            elif conn.state == "body":
                before = len(conn.buf)
                self._advance_one_body_pass(conn)
                if conn.state == "body" and len(conn.buf) == before:
                    return       # need more bytes off the socket
            else:
                return           # wait/write: resume after response

    def _begin_request(self, conn, head):
        """Head parsed → validate framing, set up the body read (or
        dispatch immediately for body-less requests). Returns False
        when the connection errored/closed."""
        req = conn.req
        try:
            method, target, headers = parse_request_head(head)
            split = urlsplit(target)    # ValueError on e.g. bad IPv6
        except ValueError as e:
            self._error(conn, 400, str(e), discard=0)
            return False
        req.update(method=method, path=split.path,
                   query={k: v[-1] for k, v in
                          parse_qs(split.query).items()},
                   headers=headers)
        try:
            # parse_request_head lowercases names; the shared helper
            # asks in canonical case
            length = framed_body_length(
                method, lambda n: headers.get(n.lower()))
        except HTTPError as e:
            # unreadable/unframed body: answer and close (the shared
            # 411/501 contract — web.http.framed_body_length)
            self._error(conn, e.status, e.message, discard=0)
            return False
        req["length"] = length
        ctype = (headers.get("content-type") or "") \
            .split(";")[0].strip().lower()
        req["binary"] = ctype == "application/x-tensor"
        tgt = serving.parse_predict_path(split.path)
        if req["binary"] and method == "POST" \
                and tgt is not None and tgt[1] == "attach":
            # KV-page bundle (:attach): multi-tensor framing — the
            # comma-joined dtype / semicolon-joined shape headers are
            # validated at dispatch by decode_kv_bundle, not by the
            # single-tensor predict parser; land the raw body in the
            # same zero-copy buffer recv_into fills
            buf = bytearray(length)
            req["tbuf"] = buf
            req["tview"] = memoryview(buf)
            req["filled"] = 0
            req["kv_attach"] = True
        elif req["binary"] and method == "POST":
            try:
                dtype, shape = serving._parse_tensor_headers(
                    {"X-Tensor-Dtype": headers.get("x-tensor-dtype"),
                     "X-Tensor-Shape": headers.get("x-tensor-shape")})
                want = int(np.prod(shape)) * dtype.itemsize
                if length != want:
                    raise ValueError(
                        f"Content-Length is {length} bytes, "
                        f"shape×dtype needs {want}")
                req.update(dtype=dtype, shape=shape)
                # the zero-copy landing zone: recv_into fills this
                # exact buffer; np.frombuffer aliases it
                buf = bytearray(length)
                req["tbuf"] = buf
                req["tview"] = memoryview(buf)
                req["filled"] = 0
            except ValueError as e:
                self._error(conn, 400, f"bad request: {e}",
                            discard=length)
                return conn.state == "body"
        else:
            req["body"] = bytearray()
        conn.state = "body"     # the _advance loop finishes the body
        return True

    def _advance_one_body_pass(self, conn):
        req = conn.req
        if req.get("discard_left") is not None:
            take = min(len(conn.buf), req["discard_left"])
            del conn.buf[:take]
            req["discard_left"] -= take
            if req["discard_left"] <= 0:
                self._flush_pending_error(conn)
        elif req.get("tview") is not None:
            take = min(len(conn.buf), req["length"] - req["filled"])
            if take:
                req["tview"][req["filled"]:req["filled"] + take] = \
                    conn.buf[:take]
                del conn.buf[:take]
                req["filled"] += take
            if req["filled"] >= req["length"]:
                self._body_complete(conn)
        else:
            take = min(len(conn.buf), req["length"] - len(req["body"]))
            if take:
                req["body"] += conn.buf[:take]
                del conn.buf[:take]
            if len(req["body"]) >= req["length"]:
                self._body_complete(conn)

    def _error(self, conn, code, message, discard=None):
        """Queue an error response. ``discard``: body bytes to consume
        FIRST so the buffered response isn't reset away by unread
        inbound data (None/0 = respond now). Error responses close the
        connection, mirroring the threaded transport."""
        payload = {"error": message}
        if discard:
            req = conn.req
            req["discard_left"] = discard - len(req.get("body") or b"")
            req.pop("tview", None)
            req.pop("tbuf", None)
            req["pending_error"] = (code, payload)
            conn.state = "body"
            self._advance_one_body_pass(conn)
        else:
            self._respond(conn, code, payload, (), "application/json")

    def _flush_pending_error(self, conn):
        code, payload = conn.req["pending_error"]
        self._respond(conn, code, payload, (), "application/json")

    # ------------------------------------------------------- dispatch

    def _body_complete(self, conn):
        req = conn.req
        now_m = time.monotonic()
        _READ_STALL.labels("async").observe(now_m - req["t0"])
        if req["method"] == "GET":
            code, payload, extra, ctype = self.server.handle_get(
                req["path"], req["query"])
            self._respond(conn, code, payload, extra, ctype)
            return
        if req["method"] != "POST":
            self._error(conn, 501,
                        f"method {req['method']} not supported")
            return
        self._dispatch_post(conn)

    def _dispatch_post(self, conn):
        req = conn.req
        headers = req["headers"]
        rt = tracing.RequestTrace(
            f"http POST {req['path']}",
            traceparent=headers.get("traceparent"),
            app="model-server")
        # widen the request window to cover the socket read (same move
        # as the web middleware): the phases must sum to the wall time
        rt.start = req["t0w"]
        rt.phase("http.read", req["t0w"])
        conn.rt = rt
        if req["path"].strip("/").split("/") == ["admin", "drain"]:
            self.server.begin_drain()
            self._respond(conn, 200, {"status": "draining"}, (),
                          "application/json")
            return
        target = serving.parse_predict_path(req["path"])
        if target is None:
            self._error(conn, 404, "not found")
            return
        name, verb = target
        if verb == "generate":
            # token-streaming decode: the engine's callbacks feed the
            # loop through the completion queue, one frame per token
            self._dispatch_generate(conn, name)
            return
        if verb == "prefill":
            # disaggregation hop 1: prefill ONLY, answer with the
            # KV-page bundle over application/x-tensor
            self._dispatch_prefill(conn, name)
            return
        if verb == "attach":
            # disaggregation hop 2: import the bundle, then stream
            # the continuation under the :generate NDJSON contract
            self._dispatch_attach(conn, name)
            return
        model = self.server._models.get(name)
        if model is None:
            self._error(conn, 404, "model not found")
            return
        model = self.server._route(name, model)
        rt.attrs["model"] = name
        rt.attrs["track"] = model.track
        if verb == "predictStream":
            self._error(conn, 501,
                        "predictStream requires the threaded "
                        "transport (SERVING_TRANSPORT=threaded)")
            return
        if verb != "predict":
            self._error(conn, 400, f"verb {verb}")
            return
        try:
            deadline = serving.parse_deadline(
                headers.get("x-request-deadline-ms"))
        except ValueError as e:
            self._error(conn, 400, f"bad request: {e}")
            return
        # decode (on the loop: ~0 for the binary path — that IS the
        # point; JSON clients pay their own parse, same as threaded)
        try:
            t_dec = time.perf_counter()
            tw_dec = time.time()
            if req["binary"]:
                x = np.frombuffer(req["tbuf"], dtype=req["dtype"]) \
                    .reshape(req["shape"])
                fmt = "binary"
            else:
                x, fmt = serving.decode_json_predict(
                    bytes(req["body"]))
            if x.ndim == 0:
                raise ValueError(
                    "instances must be a list of inputs, got a scalar")
        except (ValueError, KeyError, TypeError) as e:
            self._error(conn, 400, f"bad request: {e}")
            return
        serving._WIRE_FORMAT_TOTAL.labels(fmt).inc()
        serving._DECODE_SECONDS.labels(fmt).observe(
            time.perf_counter() - t_dec)
        rt.phase("decode", tw_dec, format=fmt)
        req["fmt"] = fmt
        req["model"] = model
        req["submit_t0"] = time.perf_counter()
        conn.state = "wait"
        self._interest(conn, 0)     # backpressure pipelined requests
        self._submit(conn, model, x, rt, deadline)

    def _dispatch_generate(self, conn, name):
        """``:generate`` on the event loop: parse the JSON request,
        submit to the model's GenerationEngine, and stream chunked
        NDJSON frames as its callbacks land on the completion queue —
        the same incremental contract as the threaded transport."""
        req, rt = conn.req, conn.rt
        engine = self.server._generators.get(name)
        if engine is None:
            self._error(conn, 404,
                        f"no generation engine registered for {name!r}")
            return
        rt.attrs["model"] = name
        rt.attrs["track"] = "stable"
        if req["binary"]:
            self._error(conn, 400,
                        "generate takes a JSON body "
                        '({"tokens": [...]}), not application/x-tensor')
            return
        try:
            deadline = serving.parse_deadline(
                req["headers"].get("x-request-deadline-ms"))
            tw_dec = time.time()
            body = json.loads(bytes(req["body"]) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            tokens = body.get("tokens")
            if tokens is None:
                raise ValueError('"tokens" is required '
                                 '(a list of prompt token ids)')
            rt.phase("decode", tw_dec, format="json")
        except (ValueError, KeyError, TypeError) as e:
            self._error(conn, 400, f"bad request: {e}")
            return
        serving._WIRE_FORMAT_TOTAL.labels("json").inc()
        gen = conn.gen
        req["model_name"] = name
        req["gen_started"] = False
        conn.state = "wait"
        self._interest(conn, 0)

        def on_token(token, index):
            self._completions.append(
                (conn, gen, ("gtoken", token, index)))
            self._wake()

        def on_event(event, attrs):
            # preemptible-decoding lifecycle (suspended/resumed) —
            # ordered behind the tokens that preceded it, like gtoken
            self._completions.append(
                (conn, gen, ("gevent", event, attrs)))
            self._wake()

        def on_done(reason, toks, error):
            self._completions.append(
                (conn, gen, ("gdone", reason, toks, error)))
            self._wake()

        try:
            req["gen_engine"] = engine
            req["gen_handle"] = engine.submit(
                tokens, max_tokens=body.get("max_tokens"),
                eos_id=body.get("eos_id"), deadline=deadline, rt=rt,
                tenant=req["headers"].get("x-tenant"),
                qos_class=req["headers"].get("x-qos-class"),
                on_token=on_token, on_event=on_event,
                on_done=on_done)
        except Exception as e:  # noqa: BLE001 — wire boundary:
            # ValueError → 400, DrainingError → clean 503 (no fallback
            # path exists for stateful decode slots), else 500
            code, payload, extra = serving.classify_predict_error(e)
            self._respond(conn, code, payload, extra,
                          "application/json")

    def _dispatch_prefill(self, conn, name):
        """``:prefill`` on the event loop: submit with
        ``export_kv=True`` — the engine thread runs prefill (chunked
        or monolithic, prefix hits honored) and finishes the handle
        with the page bundle attached; the done callback hands it
        back to the loop, which answers with the encode_kv_bundle
        multi-tensor response."""
        req, rt = conn.req, conn.rt
        engine = self.server._generators.get(name)
        if engine is None:
            self._error(conn, 404,
                        f"no generation engine registered for {name!r}")
            return
        rt.attrs["model"] = name
        rt.attrs["track"] = "stable"
        if req["binary"]:
            self._error(conn, 400,
                        "prefill takes a JSON body "
                        '({"tokens": [...]}), not application/x-tensor')
            return
        try:
            deadline = serving.parse_deadline(
                req["headers"].get("x-request-deadline-ms"))
            tw_dec = time.time()
            body = json.loads(bytes(req["body"]) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            tokens = body.get("tokens")
            if tokens is None:
                raise ValueError('"tokens" is required '
                                 '(a list of prompt token ids)')
            rt.phase("decode", tw_dec, format="json")
        except (ValueError, KeyError, TypeError) as e:
            self._error(conn, 400, f"bad request: {e}")
            return
        serving._WIRE_FORMAT_TOTAL.labels("json").inc()
        gen = conn.gen
        req["model_name"] = name
        conn.state = "wait"
        self._interest(conn, 0)

        def on_done(reason, toks, error):
            self._completions.append(
                (conn, gen, ("gexport", reason, error)))
            self._wake()

        try:
            req["gen_engine"] = engine
            req["gen_handle"] = engine.submit(
                tokens, max_tokens=body.get("max_tokens"),
                eos_id=body.get("eos_id"), deadline=deadline, rt=rt,
                tenant=req["headers"].get("x-tenant"),
                qos_class=req["headers"].get("x-qos-class"),
                export_kv=True, on_done=on_done)
        except Exception as e:  # noqa: BLE001 — wire boundary
            code, payload, extra = serving.classify_predict_error(e)
            self._respond(conn, code, payload, extra,
                          "application/json")

    def _complete_prefill(self, conn, outcome):
        """The export handle finished on the engine thread — answer
        with the bundle (or the predict error taxonomy)."""
        _kind, reason, error = outcome
        req, rt = conn.req, conn.rt
        handle = req.get("gen_handle")
        bundle = handle.kv_bundle if handle is not None else None
        if error is not None or bundle is None:
            code, payload, extra = serving.classify_predict_error(
                error if error is not None
                else RuntimeError(
                    f"prefill export finished with reason "
                    f"{reason!r} and no bundle"))
            self._respond(conn, code, payload, extra,
                          "application/json")
            return
        t_enc = time.time()
        parts, extra, ctype = serving.encode_kv_bundle(bundle)
        rt.phase("encode", t_enc, format="binary")
        engine = req["gen_engine"]
        self._respond(
            conn, 200, parts,
            extra + (("X-Served-Version", str(engine.version)),
                     ("X-Prefix-Tokens-Skipped",
                      str(bundle["meta"].get(
                          "prefix_tokens_skipped", 0)))),
            ctype)

    def _dispatch_attach(self, conn, name):
        """``:attach`` on the event loop: decode the bundle framing
        (zero-copy over the landed body buffer), import into free
        blocks, and stream the continuation through the SAME gtoken/
        gdone machinery as ``:generate``."""
        req, rt = conn.req, conn.rt
        engine = self.server._generators.get(name)
        if engine is None:
            self._error(conn, 404,
                        f"no generation engine registered for {name!r}")
            return
        rt.attrs["model"] = name
        rt.attrs["track"] = "stable"
        headers = req["headers"]
        if not req.get("kv_attach"):
            self._error(conn, 400,
                        "attach takes an application/x-tensor KV-page "
                        "bundle body (encode_kv_bundle framing)")
            return
        try:
            deadline = serving.parse_deadline(
                headers.get("x-request-deadline-ms"))
            tw_dec = time.time()
            # parse_request_head lowercased the names; the shared
            # codec asks in canonical case
            bundle = serving.decode_kv_bundle(
                {"X-KV-Meta-Bytes": headers.get("x-kv-meta-bytes"),
                 "X-Tensor-Dtype": headers.get("x-tensor-dtype"),
                 "X-Tensor-Shape": headers.get("x-tensor-shape")},
                req["tbuf"])
            rt.phase("decode", tw_dec, format="binary")
        except (ValueError, KeyError, TypeError) as e:
            self._error(conn, 400, f"bad request: {e}")
            return
        serving._WIRE_FORMAT_TOTAL.labels("binary").inc()
        meta = bundle["meta"]
        req["kv_bytes"] = (
            int(meta.get("page_bytes") or 0)
            + int(meta.get("scale_bytes") or 0)) \
            or sum(p.nbytes for p in bundle["pages"])
        gen = conn.gen
        req["model_name"] = name
        req["gen_started"] = False
        conn.state = "wait"
        self._interest(conn, 0)

        def on_token(token, index):
            self._completions.append(
                (conn, gen, ("gtoken", token, index)))
            self._wake()

        def on_event(event, attrs):
            self._completions.append(
                (conn, gen, ("gevent", event, attrs)))
            self._wake()

        def on_done(reason, toks, error):
            self._completions.append(
                (conn, gen, ("gdone", reason, toks, error)))
            self._wake()

        try:
            req["gen_engine"] = engine
            req["gen_handle"] = engine.import_bundle(
                bundle, deadline=deadline, rt=rt,
                tenant=headers.get("x-tenant"),
                qos_class=headers.get("x-qos-class"),
                on_token=on_token, on_event=on_event,
                on_done=on_done)
        except Exception as e:  # noqa: BLE001 — wire boundary:
            # KVImportError → 400 (the router maps any import
            # rejection to its colocated fallback), DrainingError →
            # clean 503, else 500
            code, payload, extra = serving.classify_predict_error(e)
            self._respond(conn, code, payload, extra,
                          "application/json")

    def _begin_stream(self, conn):
        """Queue the chunked 200 head for a token stream and install
        the close-time bookkeeping (SLO count + trace finish) so a
        client that abandons mid-stream is still accounted."""
        req, rt = conn.req, conn.rt
        engine = req["gen_engine"]
        handle = req.get("gen_handle")
        lines = ["HTTP/1.1 200 OK",
                 "Content-Type: application/x-ndjson",
                 "Transfer-Encoding: chunked",
                 f"X-Served-Version: {engine.version}",
                 # prefill already ran (the first token came from it):
                 # per-request prefix-cache savings, router-mirrored
                 f"X-Prefix-Tokens-Skipped: "
                 f"{handle.prefix_tokens_skipped if handle else 0}",
                 # sharding summary (tensor mesh size + per-chip
                 # block count), router-mirrored like the prefix one
                 f"X-Generate-Mesh: {engine.mesh_header()}"]
        # resolved QoS class (threaded parity), router-mirrored
        if handle is not None:
            lines.append(f"X-QoS-Class: {handle.qos_class}")
        # migration economics for the two-hop flow (threaded parity):
        # bundle bytes this slot imported, router-mirrored
        if req.get("kv_bytes") is not None:
            lines.append(f"X-KV-Bytes-Migrated: {req['kv_bytes']}")
        # speculative economics (engine-cumulative exact counts
        # FROZEN at this request's prefill; omitted when speculation
        # is off — byte-identical plain contract), router-mirrored
        # like the prefix header
        if handle is not None and handle.spec_wire is not None:
            lines.append(f"X-Spec-Acceptance: {handle.spec_wire}")
        # time-to-first-token in ms (the head goes out after the
        # first token, so it is known here) — same rounded value the
        # done frame carries; router-mirrored (threaded parity)
        ttft_ms = engine.ttft_header(handle) \
            if handle is not None else None
        if ttft_ms is not None:
            lines.append(f"X-TTFT-Ms: {ttft_ms}")
        if rt is not None:
            lines.append(
                f"traceparent: {tracing.format_traceparent(rt)}")
            rt.attrs["code"] = 200
        if conn.close_after or self._draining or self._stop:
            lines.append("Connection: close")
            conn.close_after = True
        conn.out.append(memoryview(
            ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")))
        conn.state = "stream"
        conn.write_t0 = time.monotonic()
        req["gen_started"] = True
        model_name = req.get("model_name")

        def finish():
            if rt is not None:
                if model_name is not None:
                    serving._REQUESTS_TOTAL.labels(
                        model_name, "200").inc()
                rt.finish()

        conn.finish_cb = finish

    def _stream_chunk(self, conn, payload):
        body = json.dumps(payload).encode() + b"\n"
        conn.out.append(memoryview(
            f"{len(body):X}\r\n".encode() + body + b"\r\n"))

    def _gen_event(self, conn, outcome):
        """One engine callback delivered on the loop thread."""
        req = conn.req
        if outcome[0] == "gtoken":
            if not req.get("gen_started"):
                self._begin_stream(conn)
            self._stream_chunk(conn, {"token": outcome[1],
                                      "index": outcome[2]})
            self._flush(conn)
            return
        if outcome[0] == "gevent":
            # suspended/resumed lifecycle frame (threaded parity: no
            # "token" key, so token-consuming clients skip it). The
            # engine only suspends slots that already emitted, so the
            # stream head is always out; drop the frame otherwise.
            if req.get("gen_started"):
                self._stream_chunk(conn, {"event": outcome[1],
                                          **outcome[2]})
                self._flush(conn)
            return
        _kind, reason, toks, error = outcome
        if not req.get("gen_started"):
            # finished before ANY token: queue-side failure (drain,
            # deadline, crash) — answer with the plain predict error
            # taxonomy instead of a zero-token stream
            code, payload, extra = serving.classify_predict_error(
                error if error is not None
                else RuntimeError(f"generation ended: {reason}"))
            self._respond(conn, code, payload, extra,
                          "application/json")
            return
        handle = req.get("gen_handle")
        done = {"done": True, "reason": reason, "tokens": toks,
                # per-request prefix-cache view (same fields as the
                # threaded transport: byte-identical contracts)
                "prefix_tokens_skipped":
                    handle.prefix_tokens_skipped if handle else 0,
                "prefill_s": round(handle.prefill_seconds, 6)
                    if handle is not None
                    and handle.prefill_seconds is not None else None,
                # mesh shape + per-chip blocks (threaded parity)
                "mesh": req["gen_engine"].mesh_view()}
        # token-latency economics (threaded parity): ttft_s matches
        # the X-TTFT-Ms head exactly — same rounded value
        if handle is not None:
            done.update(req["gen_engine"].token_latency_view(handle))
        # paged-attention read backend (threaded parity:
        # UNCONDITIONAL since the paged default flip)
        done["attn_backend"] = req["gen_engine"].attn_view()
        # per-request speculative economics (threaded parity: key
        # absent when speculation is off)
        spec = req["gen_engine"].spec_view(handle) \
            if handle is not None else None
        if spec is not None:
            done["spec"] = spec
        # tenancy economics (threaded parity: key absent for
        # anonymous never-preempted requests)
        qos = req["gen_engine"].qos_view(handle) \
            if handle is not None else None
        if qos is not None:
            done["qos"] = qos
        if error is not None:
            done["error"] = str(error)
        self._stream_chunk(conn, done)
        conn.out.append(memoryview(b"0\r\n\r\n"))
        if self._draining or self._stop:
            conn.close_after = True
        # hand the tail to the normal write path: when out drains it
        # runs finish_cb and resets the connection for keep-alive
        conn.state = "write"
        conn.write_t0 = time.monotonic()   # stall metric = tail flush
        self._flush(conn)

    def _flush(self, conn):
        self._on_writable(conn)      # optimistic write
        if conn.out and conn in self._conns:
            self._interest(conn, selectors.EVENT_WRITE)

    def _submit(self, conn, model, x, rt, deadline):
        gen = conn.gen

        def resolved(slot):
            # batcher worker thread → loop thread handoff
            if "error" in slot:
                outcome = ("err", slot["error"])
            else:
                outcome = ("ok", slot["out"], slot["ms"])
            self._completions.append((conn, gen, outcome))
            self._wake()

        if model._batcher is not None:
            try:
                model._batcher.submit_async(x, rt=rt, deadline=deadline,
                                            on_done=resolved)
                return
            except RuntimeError as e:
                if "batcher stopped" not in str(e) \
                        or not model._batcher._graceful_stop:
                    self._completions.append((conn, gen, ("err", e)))
                    self._wake()
                    return
                # straggler across a graceful version swap: fall back
                # to the direct run path, same as predict_raw
        def direct():
            t0 = time.perf_counter()
            tw = time.time()
            try:
                out = model._run(x)
                if rt is not None:
                    rt.phase("device", tw)
                outcome = ("ok", out,
                           1000 * (time.perf_counter() - t0))
            except BaseException as e:  # noqa: BLE001 — wire boundary
                outcome = ("err", e)
            self._completions.append((conn, gen, outcome))
            self._wake()

        self._jobs.put(direct)

    def _job_worker(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                job()
            except Exception:   # noqa: BLE001 — job reports its own
                log.exception("async direct-path job crashed")

    def _complete_predict(self, conn, outcome):
        req, rt = conn.req, conn.rt
        elapsed = time.perf_counter() - req["submit_t0"]
        model = req["model"]
        if outcome[0] == "err":
            code, payload, extra = serving.classify_predict_error(
                outcome[1])
            self._respond(conn, code, payload, extra,
                          "application/json")
            return
        _out, ms = outcome[1], outcome[2]
        serving._REQUEST_SECONDS.labels(model.name, model.track) \
            .observe(elapsed, trace_id=rt.exemplar(elapsed))
        t_enc = time.time()
        parts, extra, ctype = serving.encode_predict_response(
            _out, req["fmt"], ms, model.version)
        rt.phase("encode", t_enc, format=req["fmt"])
        self._respond(conn, 200, parts, extra, ctype)

    # ------------------------------------------------------ responses

    def _respond(self, conn, code, payload, extra_headers,
                 content_type):
        """Encode EXACTLY like the threaded ``_send`` (list/tuple =
        pre-encoded parts, bytes/memoryview verbatim, anything else
        ``json.dumps``) so the two transports answer byte-identically,
        then queue head + parts as separate writes."""
        if isinstance(payload, (list, tuple)):
            parts = list(payload)
        elif isinstance(payload, (bytes, memoryview)):
            parts = [payload]
        else:
            parts = [json.dumps(payload).encode()]
        rt = conn.rt
        close = (conn.close_after or code >= 400 or self._draining
                 or self._stop)
        reason = http.client.responses.get(code, "Unknown")
        lines = [f"HTTP/1.1 {code} {reason}",
                 f"Content-Type: {content_type}",
                 f"Content-Length: {sum(len(p) for p in parts)}"]
        if rt is not None:
            lines.append(
                f"traceparent: {tracing.format_traceparent(rt)}")
            rt.attrs["code"] = code
            if code >= 500:
                rt.status = "error"
        if close:
            lines.append("Connection: close")
            conn.close_after = True
        for k, v in extra_headers:
            lines.append(f"{k}: {v}")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        conn.out.append(memoryview(head))
        for p in parts:
            conn.out.append(p if isinstance(p, memoryview)
                            else memoryview(p))
        conn.state = "write"
        conn.write_t0 = time.monotonic()
        model_name = rt.attrs.get("model") if rt is not None else None

        def finish():
            # response fully handed to the kernel: close the anatomy
            # (write phase from loop callbacks), count the SLO source,
            # and reset for the next keep-alive request
            if rt is not None:
                rt.phase("http.write", t_first_write[0])
                if model_name is not None:
                    serving._REQUESTS_TOTAL.labels(
                        model_name, str(code)).inc()
                rt.finish()

        t_first_write = [time.time()]
        conn.finish_cb = finish
        self._on_writable(conn)      # optimistic first write
        if conn.out and conn in self._conns:
            self._interest(conn, selectors.EVENT_WRITE)

    def _on_writable(self, conn):
        conn.last_activity = time.monotonic()
        while conn.out:
            mv = conn.out[0]
            try:
                n = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close(conn)
                return
            if n < len(mv):
                conn.out[0] = mv[n:]
                return
            conn.out.popleft()
        if conn.state == "stream":
            # mid-stream lull: every queued frame is on the wire, more
            # may come from the engine — park with no interests (the
            # completion queue wakes the loop, not the selector) and
            # keep finish_cb armed for close-time accounting
            self._interest(conn, 0)
            return
        # drained: bookkeeping, then next request or close
        _WRITE_STALL.labels("async").observe(
            time.monotonic() - conn.write_t0)
        cb, conn.finish_cb = conn.finish_cb, None
        if cb is not None:
            cb()
        if conn.close_after:
            self._close(conn)
            return
        conn.req = None
        conn.rt = None
        conn.state = "head"
        self._interest(conn, selectors.EVENT_READ)
        if conn.buf:
            # pipelined request already buffered: parse it now rather
            # than waiting for more bytes that may never come
            self._advance(conn)
