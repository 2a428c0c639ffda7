"""The ``:generate`` serving plane of the port: ``ModelServer`` streams
a :class:`~kubeflow_tpu_torch.compute.generate.GenerationEngine` over
HTTP under the JAX package's wire contract
(``kubeflow_tpu/compute/serving.py``), byte for byte in its paths,
headers, NDJSON frames and error taxonomy.

- ``POST /v1/models/<name>:generate`` with ``{"tokens": [ids],
  "max_tokens"?, "eos_id"?}``: chunked ``application/x-ndjson``, one
  ``{"token", "index"}`` frame per generated token the moment the
  engine emits it, then one ``{"done": true, ...}`` frame. Headers
  ``X-Served-Version``, ``X-Prefix-Tokens-Skipped``, ``X-Generate-Mesh``,
  ``X-QoS-Class``, ``X-Spec-Acceptance`` (speculation on),
  ``X-TTFT-Ms`` and ``traceparent``. ``X-Request-Deadline-Ms`` bounds
  the request: a queued prompt answers 504, a streaming one ends with
  a ``deadline`` frame. A client that disconnects mid-stream cancels
  its slot (reason ``disconnect``).
- ``GET /healthz``, ``/metrics``, ``/debug/traces``, ``/debug/latency``,
  ``/v1/models`` and ``/v1/models/<name>``; ``POST /admin/drain``.
- The threaded transport only (``ThreadingHTTPServer``, one handler
  thread per connection, HTTP/1.1 keep-alive). The handler threads move
  plain Python ints through a ``queue.Queue``; every device call stays
  on the engine's own thread.

- ``POST /v1/models/<name>:prefill`` (the body of ``:generate``): the
  engine prefills only and answers 200 ``application/x-tensor`` with
  the prompt's KV pages as a bundle (``encode_kv_bundle``), headers
  ``X-KV-Meta-Bytes``, ``X-Tensor-Dtype``, ``X-Tensor-Shape``,
  ``X-Served-Version`` and ``X-Prefix-Tokens-Skipped``.
  ``POST /v1/models/<name>:attach`` with that body and its three framing
  headers: the engine imports the pages into free blocks and streams the
  continuation as ``:generate`` does, plus ``X-KV-Bytes-Migrated``; a
  malformed bundle or one the pool cannot take (``KVImportError``)
  answers 400.

Not served yet, each refused by name: the unary ``:predict`` and
``:predictStream`` verbs (501) and the async transport (``ValueError``).
"""

import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import tracing
from ..web.http import HTTPError, framed_body_length

_WIRE_FORMAT_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_wire_format_total",
    "Successfully decoded predict payloads by wire format "
    "(json | b64 | binary; stream lines count per line)",
    ("format",))
_REQUESTS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_requests_total",
    "Predict-route responses by model and HTTP status code — the "
    "serving error-ratio SLO source (obs/slo.py)",
    ("model", "code"))

#: pad prefill prompts up to one of these
BATCH_BUCKETS = (1, 8, 16, 32, 64, 256)

#: what the port does not serve yet, and the work that brings it
UNARY_PREDICT_MISSING = (
    "the unary predict plane (ServedModel, its batcher and the x-tensor "
    "codec) is not ported yet; it comes with the port's unary-predict "
    "slice")
ASYNC_TRANSPORT_MISSING = (
    "the async serving transport is not ported yet (threaded only); "
    "it comes with the port's async-transport slice")


def bucket_for(n):
    """Smallest padded bucket that fits ``n`` rows (``n`` itself past
    the largest bucket) — the ONE bucketing policy."""
    return next((b for b in BATCH_BUCKETS if b >= n), n)


class DeadlineExceededError(Exception):
    """The request's propagated deadline expired while it sat in the
    admission queue — answered 504 without a prefill."""


class ModelTooLargeError(Exception):
    """The model alone exceeds the server's byte budget (permanent)."""


class CapacityBusyError(Exception):
    """Budget temporarily exhausted by unevictable mid-transition
    copies — retry after the transition completes (503, not 507)."""


class DrainingError(Exception):
    """The serving target is draining (server drain, or a displaced
    generation engine): the request is retryable against another
    replica — 503 + Retry-After. A generation engine's slots are
    stateful; there is nothing to fall back to."""


def parse_predict_path(path):
    """``/v1/models/<name>:<verb>`` → ``(name, verb)``, else None."""
    parts = path.strip("/").split("/")
    if (len(parts) != 3 or parts[:2] != ["v1", "models"]
            or ":" not in parts[2]):
        return None
    name, verb = parts[2].rsplit(":", 1)
    return name, verb


def parse_deadline(raw):
    """``X-Request-Deadline-Ms`` header value → absolute
    ``time.monotonic`` deadline (None = no deadline; malformed →
    ValueError → 400)."""
    if raw is None or not str(raw).strip():
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(
            f"X-Request-Deadline-Ms must be a number of "
            f"milliseconds, got {raw!r}") from None
    return time.monotonic() + max(0.0, ms) / 1000.0


def classify_predict_error(e):
    """The error taxonomy of the serving routes: 400 = the caller's
    fault, 504 = the propagated deadline expired in the queue, 507 =
    permanent capacity, 503 + Retry-After = transient pressure or a
    drain, 500 = inference failed. → ``(status, payload,
    extra_headers)``."""
    if isinstance(e, DeadlineExceededError):
        return 504, {"error": str(e)}, ()
    if isinstance(e, ModelTooLargeError):
        return 507, {"error": str(e)}, ()
    if isinstance(e, CapacityBusyError):
        return 503, {"error": str(e)}, (("Retry-After", "1"),)
    if isinstance(e, DrainingError):
        return 503, {"error": str(e)}, (("Retry-After", "1"),)
    if isinstance(e, ValueError):
        return 400, {"error": str(e)}, ()
    return 500, {"error": f"inference failed: {e}"}, ()


#: dtypes a KV-page bundle may ship: the pool's native storage dtypes
#: (compute-dtype pages, or int8 pages with their fp32 scales). bf16
#: ships raw: widening it would double the bytes, and the import is a
#: copy of the pool's own bits (``serving.py:843-847``)
KV_BUNDLE_DTYPES = {"float32", "float16", "bfloat16", "int8"}
_KV_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                    "bfloat16": torch.bfloat16, "int8": torch.int8}


def dtype_name(x):
    """A torch tensor's or numpy array's dtype by the name the wire and
    the JAX package use: ``"bfloat16"``, not ``"torch.bfloat16"``."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return x.dtype.name


def page_tensor(p):
    """One bundle component → a torch tensor. A numpy array (what the
    JAX package's codec gives) is taken as is; its bf16 (the
    ``ml_dtypes`` type, told apart by name) is read through its int16
    bits, so the port needs no ``ml_dtypes``."""
    if isinstance(p, torch.Tensor):
        return p
    a = np.ascontiguousarray(p)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.view(np.int16)
    if not a.flags.writeable:
        a = a.copy()          # torch.from_numpy shares only writable memory
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def _raw_part(p):
    """One page component → (dtype name, shape, its little-endian bytes
    as a uint8 array aliasing the component)."""
    if isinstance(p, torch.Tensor):
        p = p.detach().cpu().contiguous()
        return dtype_name(p), tuple(p.shape), \
            p.reshape(-1).view(torch.uint8).numpy()
    p = np.ascontiguousarray(p)
    if p.dtype.byteorder == ">" or (
            p.dtype.byteorder == "=" and sys.byteorder == "big"):
        p = p.astype(p.dtype.newbyteorder("<"))
    return p.dtype.name, p.shape, p.reshape(-1).view(np.uint8)


def encode_kv_bundle(bundle):
    """An engine page bundle (``{"meta", "pages"}``) → ``(parts,
    extra_headers, content_type)`` of a ``:prefill`` answer, byte for
    byte the JAX package's framing (``serving.py:859``): part 0 is the
    JSON meta, its length in ``X-KV-Meta-Bytes``; then one raw
    little-endian part per pool component (an int8 pool ships four: k,
    v, k scales, v scales), their dtypes comma-joined in
    ``X-Tensor-Dtype`` and shapes semicolon-joined in
    ``X-Tensor-Shape``. The parts alias the pages (torch tensors, or
    numpy arrays), and the transport writes each one separately."""
    meta_b = json.dumps(bundle["meta"]).encode()
    parts = [meta_b]
    dtypes, shapes = [], []
    for p in bundle["pages"]:
        name, shape, raw = _raw_part(p)
        dtypes.append(name)
        shapes.append(",".join(str(d) for d in shape))
        parts.append(memoryview(raw))
    extra = (("X-KV-Meta-Bytes", str(len(meta_b))),
             ("X-Tensor-Dtype", ",".join(dtypes)),
             ("X-Tensor-Shape", ";".join(shapes)))
    return parts, extra, "application/x-tensor"


def decode_kv_bundle(headers, body):
    """The framing headers and raw body of an ``:attach`` → ``{"meta",
    "pages", "_t_recv"}`` for ``GenerationEngine.import_bundle``
    (``serving.py:891``). The pages are CPU torch tensors over the body
    (``torch.frombuffer``: no copy when ``body`` is writable, as the
    server's ``bytearray`` is; read-only bytes are copied once). A
    malformed bundle raises ``ValueError`` (400: the caller's fault);
    a bundle the pool cannot take is the engine's ``KVImportError``.
    The host is taken to be little-endian, as torch's CPUs are."""
    t_recv = time.perf_counter()
    try:
        meta_len = int(str(headers.get("X-KV-Meta-Bytes") or "").strip())
    except ValueError:
        raise ValueError(
            "X-KV-Meta-Bytes header required (byte length of the "
            "JSON meta part)") from None
    if not 0 < meta_len <= len(body):
        raise ValueError(
            f"X-KV-Meta-Bytes says {meta_len} but the body is "
            f"{len(body)} bytes")
    try:
        meta = json.loads(bytes(body[:meta_len]))
    except ValueError:
        raise ValueError("bundle meta part is not valid JSON") from None
    if not isinstance(meta, dict):
        raise ValueError("bundle meta must be a JSON object")
    dtypes = [d.strip()
              for d in (headers.get("X-Tensor-Dtype") or "").split(",")]
    shapes_raw = (headers.get("X-Tensor-Shape") or "").split(";")
    if not dtypes[0] or len(dtypes) != len(shapes_raw):
        raise ValueError(
            "X-Tensor-Dtype (comma-joined) and X-Tensor-Shape "
            "(semicolon-joined) must list one entry per tensor part")
    if memoryview(body).readonly:
        body = bytearray(body)
    pages, off = [], meta_len
    for dname, sraw in zip(dtypes, shapes_raw):
        if dname not in KV_BUNDLE_DTYPES:
            raise ValueError(
                f"bundle dtype must be one of "
                f"{sorted(KV_BUNDLE_DTYPES)}, got {dname!r}")
        dt = _KV_TORCH_DTYPES[dname]
        try:
            shape = [int(d) for d in sraw.split(",")]
        except ValueError:
            raise ValueError(
                f"X-Tensor-Shape entries must be comma-separated "
                f"ints, got {sraw!r}") from None
        if any(d < 0 for d in shape):
            raise ValueError(
                f"X-Tensor-Shape dims must be >= 0, got {sraw!r}")
        count = int(np.prod(shape))
        want = count * dt.itemsize
        if off + want > len(body):
            raise ValueError(
                "bundle body is shorter than its declared tensor parts")
        pages.append(torch.frombuffer(body, dtype=dt, count=count,
                                      offset=off).view(shape)
                     if count else torch.empty(shape, dtype=dt))
        off += want
    if off != len(body):
        raise ValueError(
            f"{len(body) - off} trailing bytes after the last tensor part")
    return {"meta": meta, "pages": tuple(pages), "_t_recv": t_recv}


class ModelServer:
    """Registry of generation engines + the HTTP server.
    ``server.register_generator("lm", engine)`` then
    ``server.start(port)``; the JAX package's clients and router work
    unchanged."""

    def __init__(self):
        self._generators = {}     # name -> GenerationEngine
        self._httpd = None
        self._thread = None
        self._exporter = None
        self.transport = None
        self.draining = False     # begin_drain() flips healthz so the
        #                           router stops routing here

    def register_generator(self, name, engine):
        """Serve ``engine`` at ``POST /v1/models/<name>:generate``.
        Replacing a served name closes the DISPLACED engine gracefully:
        its open streams end with a ``draining`` frame and submits
        racing the swap get a clean 503."""
        old = self._generators.get(name)
        self._generators[name] = engine
        if old is not None:
            old.close(graceful=True)
        return engine

    def generators(self):
        return dict(self._generators)

    def handle_get(self, path, query):
        """GET routing → ``(status, payload, extra_headers,
        content_type)``; ``payload`` bytes pass through verbatim, else
        the handler ``json.dumps`` it."""
        parts = path.strip("/").split("/")
        json_ct = "application/json"
        if parts == ["metrics"]:
            return (200, obs_metrics.REGISTRY.exposition().encode(),
                    (), obs_metrics.TEXT_CONTENT_TYPE)
        if parts == ["debug", "traces"]:
            tid = query.get("trace_id") or None
            if query.get("format") == "chrome":
                return (200, tracing.TRACES.chrome_trace(tid), (),
                        json_ct)
            return (200, {"traces": tracing.TRACES.traces(tid)}, (),
                    json_ct)
        if parts == ["debug", "latency"]:
            return (200, tracing.latency_summary(
                tracing.TRACES.span_dicts(),
                path=query.get("path")), (), json_ct)
        if len(parts) == 3 and parts[:2] == ["v1", "models"]:
            generator = self._generators.get(parts[2])
            if generator is None:
                return 404, {"error": "model not found"}, (), json_ct
            return 200, {
                "model_version_status": [{
                    "version": str(generator.version),
                    "state": "AVAILABLE",
                    "status": {"error_code": "OK", "error_message": ""},
                }],
                "generator": generator.snapshot()}, (), json_ct
        if parts == ["v1", "models"]:
            # the JAX listing's keys; no unary model is served, so no
            # byte budget and nothing resident
            return 200, {
                "budget_bytes": None,
                "resident_bytes": 0,
                "models": [],
                "generators": [{
                    "name": name,
                    "version": str(engine.version),
                    **engine.snapshot(),
                } for name, engine in sorted(self.generators().items())]
            }, (), json_ct
        if parts == ["healthz"]:
            return (200, {"status": "draining" if self.draining
                          else "ok"}, (), json_ct)
        return 404, {"error": "not found"}, (), json_ct

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: connections persist across requests (every
            # response carries Content-Length or chunked framing); the
            # socket timeout reaps idle keep-alive connections
            protocol_version = "HTTP/1.1"
            timeout = 60
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def _body_length(self):
                """Framing first (411/413/501/400 answered here);
                None after sending the error."""
                try:
                    return framed_body_length(self.command,
                                              self.headers.get)
                except HTTPError as e:
                    self._send(e.status, {"error": e.message})
                    return None

            def _send(self, code, payload, extra_headers=(),
                      content_type="application/json"):
                if isinstance(payload, (list, tuple)):
                    # pre-encoded parts (encode_kv_bundle), written one
                    # by one: joining them would copy every page
                    parts = list(payload)
                elif isinstance(payload, (bytes, memoryview)):
                    parts = [payload]
                else:
                    parts = [json.dumps(payload).encode()]
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length",
                                 str(sum(len(p) for p in parts)))
                sp = getattr(self, "_rt", None) or \
                    tracing.current_span()
                if sp is not None:
                    self.send_header("traceparent",
                                     tracing.format_traceparent(sp))
                    sp.attrs["code"] = code
                    if code >= 500:
                        sp.status = "error"
                if code >= 400:
                    # an error path may not have drained the request
                    # body: close, and tell a keep-alive client
                    self.close_connection = True
                    self.send_header("Connection", "close")
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                rt = getattr(self, "_rt", None)
                t_write = time.time()
                for p in parts:
                    self.wfile.write(p)
                if rt is not None:
                    rt.phase("http.write", t_write)

            def do_GET(self):
                length = self._body_length()
                if length is None:
                    return
                if length:
                    self.rfile.read(length)
                split = urlsplit(self.path)
                query = {k: v[-1]
                         for k, v in parse_qs(split.query).items()}
                code, payload, extra, ctype = server.handle_get(
                    split.path, query)
                self._send(code, payload, extra, content_type=ctype)

            def do_POST(self):
                # the request recorder continues the caller's W3C trace
                # and holds the per-phase latency anatomy; the model
                # label it gathers feeds serving_requests_total
                rt = tracing.RequestTrace(
                    f"http POST {urlsplit(self.path).path}",
                    traceparent=self.headers.get("traceparent"),
                    app="model-server")
                self._rt = rt
                try:
                    self._handle_post()
                except BaseException as e:
                    rt.status = "error"
                    rt.attrs.setdefault("error",
                                        f"{type(e).__name__}: {e}")
                    raise
                finally:
                    self._rt = None
                    rt.attrs.setdefault("code", 200)  # stream path
                    model = rt.attrs.get("model")
                    if model is not None:
                        _REQUESTS_TOTAL.labels(
                            model, str(rt.attrs["code"])).inc()
                    rt.finish()

            def _handle_post(self):
                length = self._body_length()
                if length is None:
                    return
                path = urlsplit(self.path).path
                if path.strip("/").split("/") == ["admin", "drain"]:
                    if length:
                        self.rfile.read(length)
                    server.begin_drain()
                    return self._send(200, {"status": "draining"})
                target = parse_predict_path(path)
                if target is None:
                    return self._send(404, {"error": "not found"})
                name, verb = target
                if verb == "generate":
                    return self._generate_stream(name, length)
                if verb == "prefill":
                    # disaggregation hop 1: prefill only, the pages
                    # answer as an application/x-tensor bundle
                    return self._prefill_export(name, length)
                if verb == "attach":
                    # hop 2: import the bundle, stream the continuation
                    return self._generate_stream(name, length,
                                                 attach=True)
                if verb in ("predict", "predictStream"):
                    return self._send(501, {
                        "error": f":{verb} is not served: "
                                 f"{UNARY_PREDICT_MISSING}"})
                return self._send(404, {"error": "model not found"})

            def _read_body(self, length):
                """The request body into a writable ``bytearray`` (the
                bundle's pages are tensors over it)."""
                buf = bytearray(length)
                view, got = memoryview(buf), 0
                while got < length:
                    n = self.rfile.readinto(view[got:])
                    if not n:
                        break
                    got += n
                return buf if got == length else buf[:got]

            def _read_json(self, length):
                """A ``:generate``-shaped body → the request dict, with
                its ``http.read`` and ``decode`` phases; raises
                ValueError (400) for a malformed one."""
                rt = self._rt
                t_read = time.time()
                raw = self.rfile.read(length) if length else b""
                rt.phase("http.read", t_read)
                t_dec = time.time()
                req = json.loads(raw or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                if req.get("tokens") is None:
                    raise ValueError('"tokens" is required '
                                     '(a list of prompt token ids)')
                rt.phase("decode", t_dec, format="json")
                return req

            def _generate_target(self, name):
                """The named engine and the request's deadline → (engine,
                deadline), or None after answering 404 / 400."""
                engine = server._generators.get(name)
                if engine is None:
                    self._send(404, {"error": f"no generation engine "
                                              f"registered for {name!r}"})
                    return None
                self._rt.attrs["model"] = name
                self._rt.attrs["track"] = "stable"
                try:
                    return engine, parse_deadline(
                        self.headers.get("X-Request-Deadline-Ms"))
                except ValueError as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return None

            def _prefill_export(self, name, length):
                """``:prefill``: disaggregation hop 1 — prefill only
                (chunked or monolithic, prefix-cache hits honoured) and
                answer with the prompt's KV pages as one
                ``application/x-tensor`` bundle (``encode_kv_bundle``).
                The body is ``:generate``'s; ``max_tokens`` rides the
                bundle as the importing engine's budget."""
                target = self._generate_target(name)
                if target is None:
                    return
                engine, deadline = target
                rt = self._rt
                try:
                    req = self._read_json(length)
                except (ValueError, KeyError, TypeError) as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                _WIRE_FORMAT_TOTAL.labels("json").inc()
                try:
                    bundle = engine.prefill_export(
                        req["tokens"], max_tokens=req.get("max_tokens"),
                        eos_id=req.get("eos_id"), deadline=deadline,
                        rt=rt, tenant=self.headers.get("X-Tenant"),
                        qos_class=self.headers.get("X-QoS-Class"))
                except Exception as e:  # noqa: BLE001 — wire boundary
                    code, payload, extra = classify_predict_error(e)
                    return self._send(code, payload, extra)
                t_enc = time.time()
                parts, extra, ctype = encode_kv_bundle(bundle)
                rt.phase("encode", t_enc, format="binary")
                self._send(200, parts, extra + (
                    ("X-Served-Version", str(engine.version)),
                    ("X-Prefix-Tokens-Skipped",
                     str(bundle["meta"].get("prefix_tokens_skipped", 0)))),
                    content_type=ctype)

            def _generate_stream(self, name, length, attach=False):
                """``:generate``: greedy decode through the named
                engine, streamed as chunked NDJSON. ``attach=True`` is
                ``:attach``: the body is a page bundle
                (``decode_kv_bundle``), the engine imports it and the
                same stream drains the continuation, with an
                ``X-KV-Bytes-Migrated`` head. Queue-side failures
                before any token (drain, deadline, engine crash)
                answer with the plain error taxonomy — no stream is
                started for a dead request."""
                target = self._generate_target(name)
                if target is None:
                    return
                engine, deadline = target
                rt = self._rt
                fmt = "binary" if attach else "json"
                try:
                    if attach:
                        t_read = time.time()
                        raw = self._read_body(length)
                        rt.phase("http.read", t_read)
                        t_dec = time.time()
                        bundle = decode_kv_bundle(self.headers, raw)
                        rt.phase("decode", t_dec, format=fmt)
                    else:
                        req = self._read_json(length)
                except (ValueError, KeyError, TypeError) as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                _WIRE_FORMAT_TOTAL.labels(fmt).inc()
                events = queue.Queue()
                callbacks = dict(
                    on_token=lambda t, i: events.put(("token", t, i)),
                    on_event=lambda ev, attrs: events.put(
                        ("event", ev, attrs)),
                    on_done=lambda reason, toks, error: events.put(
                        ("done", reason, toks, error)))
                kv_bytes = None
                try:
                    if attach:
                        meta = bundle["meta"]
                        kv_bytes = (int(meta.get("page_bytes") or 0)
                                    + int(meta.get("scale_bytes") or 0)) \
                            or sum(p.numel() * p.element_size()
                                   for p in bundle["pages"])
                        handle = engine.import_bundle(
                            bundle, deadline=deadline, rt=rt,
                            tenant=self.headers.get("X-Tenant"),
                            qos_class=self.headers.get("X-QoS-Class"),
                            **callbacks)
                    else:
                        handle = engine.submit(
                            req["tokens"], max_tokens=req.get("max_tokens"),
                            eos_id=req.get("eos_id"), deadline=deadline,
                            rt=rt, tenant=self.headers.get("X-Tenant"),
                            qos_class=self.headers.get("X-QoS-Class"),
                            **callbacks)
                except Exception as e:  # noqa: BLE001 — wire boundary
                    # ValueError → 400 (a KVImportError too: the router
                    # falls back to colocated serving), DrainingError →
                    # 503, else 500
                    code, payload, extra = classify_predict_error(e)
                    return self._send(code, payload, extra)
                event = events.get()
                if event[0] == "done" and not event[2]:
                    # finished before ANY token: a queue-side failure
                    code, payload, extra = classify_predict_error(
                        event[3] if event[3] is not None
                        else RuntimeError(
                            f"generation ended: {event[1]}"))
                    return self._send(code, payload, extra)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Served-Version",
                                 str(engine.version))
                # prefill already ran (the first token came from it)
                self.send_header("X-Prefix-Tokens-Skipped",
                                 str(handle.prefix_tokens_skipped))
                self.send_header("X-Generate-Mesh",
                                 engine.mesh_header())
                self.send_header("X-QoS-Class", handle.qos_class)
                if kv_bytes is not None:
                    # the bundle's pages + scales, mirrored by the router
                    self.send_header("X-KV-Bytes-Migrated", str(kv_bytes))
                if handle.spec_wire is not None:
                    self.send_header("X-Spec-Acceptance",
                                     handle.spec_wire)
                ttft_ms = engine.ttft_header(handle)
                if ttft_ms is not None:
                    self.send_header("X-TTFT-Ms", ttft_ms)
                self.send_header("traceparent",
                                 tracing.format_traceparent(rt))
                self.end_headers()

                def chunk(payload):
                    body = json.dumps(payload).encode() + b"\n"
                    self.wfile.write(
                        f"{len(body):X}\r\n".encode() + body + b"\r\n")

                try:
                    while True:
                        if event[0] == "token":
                            chunk({"token": event[1],
                                   "index": event[2]})
                        elif event[0] == "event":
                            chunk({"event": event[1], **event[2]})
                        else:
                            _kind, reason, toks, error = event
                            done = {"done": True, "reason": reason,
                                    "tokens": toks,
                                    "prefix_tokens_skipped":
                                        handle.prefix_tokens_skipped,
                                    "prefill_s":
                                        round(handle.prefill_seconds, 6)
                                        if handle.prefill_seconds
                                        is not None else None,
                                    "mesh": engine.mesh_view()}
                            done.update(
                                engine.token_latency_view(handle))
                            done["attn_backend"] = engine.attn_view()
                            spec = engine.spec_view(handle)
                            if spec is not None:
                                done["spec"] = spec
                            qos = engine.qos_view(handle)
                            if qos is not None:
                                done["qos"] = qos
                            if error is not None:
                                done["error"] = str(error)
                            chunk(done)
                            self.wfile.write(b"0\r\n\r\n")
                            return
                        event = events.get()
                except OSError:
                    # the client went away mid-stream: free the slot
                    engine.cancel(handle, reason="disconnect")
                    self.close_connection = True

        return Handler

    def start(self, port=8500, host="0.0.0.0", transport=None):
        """Serve on ``host:port`` (0 = any free port) → the bound port.
        ``transport``: ``"threaded"`` (the default; ``SERVING_TRANSPORT``
        may name it) — ``"async"`` raises ``ValueError``."""
        transport = (transport or os.environ.get("SERVING_TRANSPORT")
                     or "threaded").strip().lower()
        if transport == "async":
            raise ValueError(ASYNC_TRANSPORT_MISSING)
        if transport != "threaded":
            raise ValueError(f"unknown serving transport "
                             f"{transport!r} (threaded | async)")
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="model-server")
        self._thread.start()
        self.transport = transport
        # fleet telemetry: no-op when no shard directory resolves
        from ..obs import export as obs_export
        self._exporter = obs_export.start_exporter()
        return self._httpd.server_address[1]

    def begin_drain(self):
        """Soft drain: healthz flips to ``draining``, every engine
        evicts its slots gracefully (open streams get a ``draining``
        frame) and further ``:generate`` submits get a clean 503."""
        self.draining = True
        for engine in self.generators().values():
            engine.begin_drain()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        for engine in self.generators().values():
            engine.close()
