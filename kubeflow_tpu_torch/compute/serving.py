"""The serving plane of the port: ``ModelServer`` answers the unary
``:predict``/``:predictStream`` verbs through :class:`ServedModel` and
its continuous batcher, and streams a
:class:`~kubeflow_tpu_torch.compute.generate.GenerationEngine` on
``:generate``, under the JAX package's wire contract
(``kubeflow_tpu/compute/serving.py``), byte for byte in its paths,
headers, bodies, NDJSON frames and error taxonomy.

- ``POST /v1/models/<name>:predict`` in three formats on one route:
  JSON ``{"instances": [...]}`` (the TF-Serving contract),
  ``{"tensor": {"dtype", "shape", "b64"}}`` (base64 of the raw
  little-endian buffer) and ``Content-Type: application/x-tensor``
  (dtype and shape in ``X-Tensor-Dtype``/``X-Tensor-Shape``, the body
  the raw buffer); the answer mirrors the format, with
  ``X-Inference-Time-Ms`` and ``X-Served-Version``. Concurrent requests
  coalesce into bucket-padded device batches (``_Batcher``), the fetch
  of batch N overlapping the launch of N+1. ``X-Request-Deadline-Ms``
  sheds a request whose deadline passes in the queue (504).
- ``POST /v1/models/<name>:predictStream``: NDJSON in, chunked NDJSON
  out in order, consecutive same-shape lines coalesced up to
  ``stream_group`` rows a device call.
- Residency: ``register_loadable`` models hold their weights on the
  device only while loaded, under ``budget_bytes`` (LRU eviction, 507
  for a model larger than the budget, 503 + Retry-After while a
  transition holds it); version transitions preload and flip
  atomically; canaries take a weighted share of a name's traffic until
  promoted or rolled back.
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
- ``GET /healthz``, ``/metrics``, ``/debug/traces``, ``/debug/latency``,
  ``/v1/models`` (budget, residency, canaries, engines) and
  ``/v1/models/<name>``; ``POST /admin/drain``.
  ``/debug/traces?engine=<name>`` serves that engine's flight recorder
  (its iteration spans: ``engine.admit``, ``engine.prefill``,
  ``engine.decode.*``, ``engine.wait``) and, on the async transport, the
  loop's ``http.loop`` passes — ``&format=chrome`` as Chrome trace
  events on the wall clock, to open in Perfetto beside a
  ``torch.profiler`` capture of the same stretch. ``/metrics``'
  ``serving_async_loop_busy_seconds_total`` counts the async loop's wall
  time outside ``select()``: its rate is the share of each second the
  loop thread holds the interpreter beside the engine's thread.
- Two transports, one wire contract: ``"threaded"``
  (``ThreadingHTTPServer``, one handler thread per connection, HTTP/1.1
  keep-alive; a ``:generate`` handler moves plain Python ints through a
  ``queue.Queue``) and ``"async"`` (``serving_async.AsyncTransport``: one
  ``selectors`` loop for every connection, zero-copy x-tensor reads,
  engine callbacks handed to the loop through a deque; ``:predictStream``
  answers 501 there). On both, every engine device call stays on the
  engine's own thread, as every batched predict stays on its batcher's.

Where PyTorch differs from ``jax.jit``, the port keeps JAX's answers: a
predict callable runs eagerly under ``torch.inference_mode()`` on the
model's device (``device=None`` is the card; the CPU only by name);
inputs are padded to ``bucket_for(n)`` rows as JAX pads them, and a
float64 or int64 input is cast to float32 or int32, as JAX's x64-off
``jit`` casts it; a bfloat16 output comes back as float32.
"""

import base64
import collections
import contextlib
import json
import logging
import os
import queue
import random
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
from . import device as device_lib
from . import quantize as quantize_lib

log = logging.getLogger("kubeflow_tpu_torch.serving")

# serving-side latency/throughput families, labeled stable-vs-canary
# (the JAX package's names, help texts, labels and buckets)
_REQUEST_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_request_duration_seconds",
    "End-to-end predict latency (batching wait + device time)",
    ("model", "track"))
_QUEUE_WAIT_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_batch_queue_wait_seconds",
    "Time a predict request waited in the dynamic batcher before its "
    "device batch launched",
    ("model", "track"),
    buckets=(1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05, 0.1,
             0.5, 1.0))
_BATCH_ROWS = obs_metrics.REGISTRY.histogram(
    "serving_batch_size_rows",
    "Rows per device dispatch after dynamic-batch coalescing "
    "(pre-padding)",
    ("model", "track"),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
_DRAIN_TIMEOUT_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_drain_timeout_total",
    "Retired model batchers whose drain did not finish within the "
    "join window (unload skipped, copy left resident)",
    ("model",))
_DECODE_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_decode_seconds",
    "Host time to turn one predict request body into an ndarray "
    "(format: json = float lists, b64 = base64 tensor, binary = raw "
    "octet-stream)",
    ("format",),
    buckets=(1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025,
             0.05, 0.1, 0.25, 1.0))
_WIRE_FORMAT_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_wire_format_total",
    "Successfully decoded predict payloads by wire format "
    "(json | b64 | binary; stream lines count per line)",
    ("format",))
_BATCH_OCCUPANCY = obs_metrics.REGISTRY.histogram(
    "serving_batch_occupancy_requests",
    "Requests coalesced into one device dispatch by cross-request "
    "batching (1 = no coalescing; the continuous-batching win is this "
    "distribution's mass above 1 under concurrent load)",
    ("model", "track"),
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64))
_REQUESTS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_requests_total",
    "Predict-route responses by model and HTTP status code — the "
    "serving error-ratio SLO source (obs/slo.py)",
    ("model", "code"))
_DEADLINE_EXCEEDED = obs_metrics.REGISTRY.counter(
    "serving_deadline_exceeded_total",
    "Predict requests resolved 504 because their X-Request-Deadline-Ms "
    "expired while queued in the batcher (shed before dispatch, "
    "freeing the batch slot instead of computing a dead answer)",
    ("model",))

#: dtypes accepted on the binary tensor path (little-endian raw bytes)
TENSOR_DTYPES = {"float32", "float16", "int32", "int8", "uint8"}

#: pad request batches up to one of these
BATCH_BUCKETS = (1, 8, 16, 32, 64, 256)

def bucket_for(n):
    """Smallest padded bucket that fits ``n`` rows (``n`` itself past
    the largest bucket) — the ONE bucketing policy."""
    return next((b for b in BATCH_BUCKETS if b >= n), n)


class DeadlineExceededError(Exception):
    """The request's propagated deadline expired while it sat in the
    batch queue or the engine's admission queue — answered 504 without a
    device call."""


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


class _CallbackSlot(threading.Event):
    """A batch slot's done-event that also fires a one-shot callback with
    the slot when set: how a non-blocking submitter (the event-loop
    transport) learns, on the batcher's thread, that its slot resolved.
    Every resolution path sets ``slot["done"]``, so the callback sees
    all of them (result, dispatch error, deadline shed, drain)."""

    def __init__(self, callback):
        super().__init__()
        self._callback = callback
        self.slot = None

    def set(self):
        super().set()
        cb, self._callback = self._callback, None
        if cb is not None:
            cb(self.slot)


class _Batcher:
    """Cross-request continuous batching: concurrent predict calls (one
    per handler thread) coalesce into shape-bucketed device batches, and
    the collect of window N overlaps the device work of window N−1 (one
    batch in flight, double-buffered).

    Window policy: with nothing in flight a request dispatches as soon
    as the queue runs dry — a lone caller never waits out the window.
    While a batch is in flight, arrivals accumulate until ``max_batch``
    rows or ``timeout_s`` after the window opened, whichever first.
    Slots group by item shape and dtype (``np.concatenate`` would
    promote: a result must not depend on concurrent traffic), each
    group capped at ``max_batch`` rows; each group is one device
    dispatch."""

    def __init__(self, dispatch_fn, finalize_fn, max_batch=64,
                 timeout_s=0.005, owner=None):
        self.dispatch = dispatch_fn   # (ndarray) -> (device_future, n)
        self.finalize = finalize_fn   # (device_future, n) -> ndarray
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self.owner = owner            # ServedModel, for metric labels
        self.q = queue.Queue()
        self._stop = False
        self._accepting = True
        self._graceful_stop = False      # version transition, not a
        self._dead = threading.Event()   # shutdown; loop has exited
        self._inflight = collections.deque()  # dispatched, unfetched
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="serving-batcher")
        self.thread.start()

    def submit(self, x, rt=None, deadline=None):
        """Blocking → ``(result_rows, device_ms_of_the_batch)``.

        ``rt`` (``obs.tracing.RequestTrace``) collects the batching
        phases (``batch.queue_wait``, ``batch.dispatch``, ``device``);
        ``deadline`` (``time.monotonic`` seconds) sheds the request with
        ``DeadlineExceededError`` if it expires before its batch
        dispatches.

        The accepting/dead check and the ``q.put`` are not atomic: the
        loop's ``finally`` sets ``_dead`` BEFORE it drains, so a late
        submit either lands in a queue the loop still drains or sees
        ``_dead`` after its put and drains the queue itself — the slot
        always resolves, and a dead loop surfaces at once."""
        if not self._accepting or self._dead.is_set():
            raise RuntimeError("batcher stopped")
        done = threading.Event()
        slot = {"x": x, "done": done, "t": time.perf_counter(),
                "tw": time.time(), "rt": rt, "deadline": deadline}
        self.q.put(slot)
        if self._dead.is_set():
            # the loop exited between the check and the put: its drain
            # may have missed our slot; the drain is idempotent
            self._drain()
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["out"], slot["ms"]

    def submit_async(self, x, rt=None, deadline=None, on_done=None):
        """Non-blocking submit for an event-loop transport: returns the
        slot at once; ``on_done(slot)`` fires exactly once, on the
        batcher's thread, when the slot resolves with ``out`` + ``ms``
        or ``error``. Raises ``RuntimeError("batcher stopped")`` as
        :meth:`submit` does, under the same put-then-check discipline
        (the callback always fires)."""
        if not self._accepting or self._dead.is_set():
            raise RuntimeError("batcher stopped")
        done = _CallbackSlot(on_done)
        slot = {"x": x, "done": done, "t": time.perf_counter(),
                "tw": time.time(), "rt": rt, "deadline": deadline}
        done.slot = slot
        self.q.put(slot)
        if self._dead.is_set():
            self._drain()
        return slot

    def _loop(self):
        try:
            while not self._stop:
                if self._inflight:
                    # a batch is on the device: take queued work if any,
                    # else retire the oldest batch
                    try:
                        first = self.q.get_nowait()
                    except queue.Empty:
                        self._finalize_one()
                        continue
                else:
                    try:
                        first = self.q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                if first is None:
                    return
                # never kill the thread: a dead batcher would fail every
                # later predict on the model
                try:
                    self._collect_and_dispatch(first)
                except Exception:  # noqa: BLE001 — keep serving
                    pass   # the collect's finally resolved every slot
        finally:
            # _dead first, so a submit racing the exit sees it after its
            # put and drains itself
            self._dead.set()
            try:
                while self._inflight:
                    try:
                        self._finalize_one()
                    except BaseException:  # noqa: BLE001 — teardown:
                        pass   # its finally resolved the group
            finally:
                self._drain()

    def _drain(self):
        """Fail every queued request (shutdown) instead of leaving its
        caller blocked."""
        while True:
            try:
                slot = self.q.get_nowait()
            except queue.Empty:
                return
            if slot is None:
                continue
            slot["error"] = RuntimeError("batcher stopped")
            slot["done"].set()

    def _collect_and_dispatch(self, first):
        taken = [first]
        try:
            def key(s):
                return (s["x"].shape[1:], s["x"].dtype)

            # groups: same-key slot lists, each capped at max_batch rows
            # so a coalesced batch never overshoots its bucket; overflow
            # opens a fresh group for the key
            groups = []
            fillable = {}       # key -> index into groups

            def add(slot):
                k = key(slot)
                n = slot["x"].shape[0]
                i = fillable.get(k)
                if i is not None and sum(
                        g["x"].shape[0] for g in groups[i]) + n \
                        <= self.max_batch:
                    groups[i].append(slot)
                else:
                    fillable[k] = len(groups)
                    groups.append([slot])

            add(first)
            rows = first["x"].shape[0]
            stopping = False
            deadline = time.monotonic() + self.timeout_s
            while rows < self.max_batch:
                if self._inflight:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self.q.get(timeout=remaining)
                    except queue.Empty:
                        break
                else:
                    # device idle: dispatch the moment the queue runs dry
                    try:
                        nxt = self.q.get_nowait()
                    except queue.Empty:
                        break
                if nxt is None:    # stop(): flush what we collected
                    stopping = True
                    break
                taken.append(nxt)
                add(nxt)
                rows += nxt["x"].shape[0]
            for group in groups:
                self._dispatch_group(group)
                # double buffering: one batch stays on the device while
                # the next window is collected
                while len(self._inflight) > 1:
                    self._finalize_one()
            if stopping:
                self._stop = True
        finally:
            # resolve every slot this window took: a crash above (even a
            # BaseException) must not leave a caller blocked
            err = sys.exc_info()[1]
            for s in taken:
                if not s.get("launched") and not s["done"].is_set():
                    s["error"] = err or RuntimeError("batcher stopped")
                    s["done"].set()

    def _dispatch_group(self, group):
        """One group → one device launch, pushed onto the in-flight
        queue; a dispatch failure resolves the whole group. Requests
        whose deadline passed while queued are shed here, the last
        moment before the device is committed (504)."""
        if any(g.get("deadline") is not None for g in group):
            now_m = time.monotonic()
            live = []
            for g in group:
                dl = g.get("deadline")
                if dl is not None and now_m >= dl:
                    if self.owner is not None:
                        _DEADLINE_EXCEEDED.labels(
                            self.owner.name).inc()
                    waited = time.perf_counter() - g["t"]
                    g["error"] = DeadlineExceededError(
                        f"deadline expired while queued for batching "
                        f"(waited {waited * 1000:.0f} ms)")
                    g["done"].set()
                else:
                    live.append(g)
            group = live
            if not group:
                return
        now_w = time.time()
        if self.owner is not None:
            now = time.perf_counter()
            wait = _QUEUE_WAIT_SECONDS.labels(self.owner.name,
                                              self.owner.track)
            for g in group:
                wait.observe(now - g["t"])
            _BATCH_OCCUPANCY.labels(
                self.owner.name, self.owner.track).observe(len(group))
        for g in group:
            if g.get("rt") is not None:
                g["rt"].phase("batch.queue_wait", g["tw"], now_w)
        try:
            x = np.concatenate([g["x"] for g in group], axis=0) \
                if len(group) > 1 else group[0]["x"]
            t0 = time.perf_counter()
            fut, n = self.dispatch(x)
        except Exception as e:  # noqa: BLE001 — propagate per-request
            for g in group:
                g["error"] = e
                g["done"].set()
            return
        tw1 = time.time()
        for g in group:
            g["launched"] = True
            if g.get("rt") is not None:
                g["rt"].phase("batch.dispatch", now_w, tw1)
        self._inflight.append(
            {"group": group, "fut": fut, "rows": n, "t0": t0,
             "tw0": tw1})

    def _finalize_one(self):
        """Wait for the oldest in-flight batch and resolve its slots.
        An Exception resolves them with the error (the loop keeps
        serving); a BaseException also re-raises after the finally
        resolved every slot."""
        rec = self._inflight.popleft()
        group = rec["group"]
        try:
            out = self.finalize(rec["fut"], rec["rows"])
            # launch → fetched, overlap with the next window's collect
            # included: what X-Inference-Time-Ms reports
            ms = 1000 * (time.perf_counter() - rec["t0"])
            end_w = time.time()
            off = 0
            for g in group:
                n = g["x"].shape[0]
                g["out"] = out[off:off + n]
                g["ms"] = ms
                off += n
                if g.get("rt") is not None:
                    g["rt"].phase("device", rec["tw0"], end_w)
        except Exception as e:  # noqa: BLE001 — propagate per-request
            for g in group:
                g["error"] = e
        finally:
            err = sys.exc_info()[1]   # only a BaseException is left here
            for g in group:
                if "out" not in g and "error" not in g:
                    g["error"] = err or RuntimeError("batcher stopped")
                g["done"].set()

    def stop(self, graceful=False):
        """``graceful``: refuse new submissions, let queued requests
        finish, and let stragglers that already resolved the model run
        direct (a version transition must not 500 in-flight work); by
        default the queue errors out and nothing falls back
        (shutdown)."""
        self._accepting = False
        if graceful:
            self._graceful_stop = True
        else:
            self._stop = True
        self.q.put(None)


def tree_bytes(params):
    """A host tree's byte size (its device residency once loaded); an
    int8 tree counts its codes and scales (``quantize.quantized_bytes``)."""
    return quantize_lib.quantized_bytes(params)[0]


def _canonical_input(x):
    """The input as ``jax.jit`` (64-bit types off) takes it: float64 →
    float32 and int64 → int32; every other dtype is kept."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        return x.astype(np.float32)
    if x.dtype == np.int64:
        return x.astype(np.int32)
    return x


def _to_device(tree, device):
    """A host tree (nested dicts, lists, tuples of tensors) → the same
    tree with every tensor on ``device``; other values (an int8 leaf's
    ``_int8`` flag) stay as given."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class _Fetch:
    """A card's output on its way to the host: the pinned host tensor a
    non-blocking copy fills, and the event recorded after that copy."""

    def __init__(self, host, done):
        self.host = host
        self.done = done


class ServedModel:
    """One model on one device (``device=None``: the card; a CUDA-less
    host raises, and the CPU must be named). Two construction modes:

    - closure (``predict_fn(x)``): always resident, bytes unmanaged;
    - managed (``make_fn(params, x)`` + ``host_params``, a host tree):
      the server owns the device residency. The weights are on the
      device only while loaded and reach the callable as an ARGUMENT, so
      ``unload()`` frees their memory once no in-flight dispatch holds
      them — what the int8 variant's smaller tree buys under a budget.

    The callable runs eagerly under ``torch.inference_mode()`` on a
    tensor on the device; its output is a tensor (on the device or the
    host) or an array."""

    def __init__(self, name, predict_fn=None, version=1, batching=True,
                 max_batch=64, batch_timeout_ms=5.0, make_fn=None,
                 host_params=None, device=None):
        self.device = device_lib.resolve(device)
        self.name = name
        self.version = version
        self.track = "stable"   # "canary" while shadowing a stable
        self.device_calls = 0
        self.loads = 0
        self.evictions = 0
        self.last_used = time.monotonic()
        self._managed = make_fn is not None
        self._make_fn = make_fn       # (params, x) -> out
        self._host_params = host_params
        self._fn = predict_fn         # (x) -> out
        self.resident_bytes = tree_bytes(host_params) if self._managed \
            else 0
        self._dev_params = None
        self._ensure = None            # server residency hook
        # cross-request batching is the default; batching=False keeps
        # the direct call path (callers that batch themselves)
        self._batcher = _Batcher(
            self.dispatch, self.finalize, max_batch=max_batch,
            timeout_s=batch_timeout_ms / 1000.0,
            owner=self) if batching else None

    @property
    def loaded(self):
        return (not self._managed) or self._dev_params is not None

    def load(self):
        if not self._managed or self._dev_params is not None:
            return
        self._dev_params = _to_device(self._host_params, self.device)
        self.loads += 1
        # a freshly loaded model must not be the coldest LRU victim
        self.last_used = time.monotonic()

    def unload(self):
        """Drop the device copy; its memory is freed once no in-flight
        dispatch still holds the old reference (those complete
        safely)."""
        if self._managed:
            self._dev_params = None
            self.evictions += 1

    def _run(self, x):
        out, n = self.dispatch(x)
        return self.finalize(out, n)

    def _upload(self, x):
        """numpy → a tensor on the model's device; to a card from pinned
        memory, asynchronously on the current stream."""
        t = torch.from_numpy(x if x.flags.writeable else x.copy())
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _fetch(out):
        """A card's output → a ``_Fetch``: a non-blocking copy into
        pinned host memory and an event after it, so ``finalize`` waits
        for this batch alone, not for a batch launched after it on the
        same stream. Anything else passes through."""
        if not (isinstance(out, torch.Tensor) and out.is_cuda):
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return _Fetch(host, done)

    def dispatch(self, x):
        """Launch half: pad to a bucket and launch the callable without
        waiting for its result → ``(future, rows)``."""
        if self._managed:
            if self._ensure is not None:
                # the hook returns the device tree pinned under the
                # residency lock: re-reading _dev_params here would race
                # an eviction; this reference keeps the weights alive
                # through the launch even if they are evicted
                params = self._ensure(self)
            else:
                self.load()
                params = self._dev_params
        self.last_used = time.monotonic()
        n = x.shape[0]
        # one observation per device call (batcher groups, stream
        # groups and direct predicts all come through here)
        _BATCH_ROWS.labels(self.name, self.track).observe(n)
        x = _canonical_input(x)
        bucket = bucket_for(n)
        if bucket > n:
            pad = np.zeros((bucket - n,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        self.device_calls += 1
        card = torch.cuda.device(self.device) if self.device.type == \
            "cuda" else contextlib.nullcontext()
        with card, torch.inference_mode():
            xt = self._upload(x)
            out = self._make_fn(params, xt) if self._managed \
                else self._fn(xt)
            return self._fetch(out), n

    @staticmethod
    def finalize(out, n):
        """Blocking half: the first ``n`` rows on the host as an array
        (bfloat16 widened to float32, which is exact)."""
        if isinstance(out, _Fetch):
            out.done.synchronize()
            out = out.host
        if isinstance(out, torch.Tensor):
            out = out.detach()[:n]
            if out.dtype == torch.bfloat16:
                out = out.float()
            return out.cpu().numpy()
        return np.asarray(out)[:n]

    def predict(self, instances):
        return self.predict_timed(instances)[0]

    def predict_raw(self, x, rt=None, deadline=None):
        """→ ``(ndarray, device_ms)``, the binary path's core; the JSON
        path wraps it. ``rt`` (``obs.tracing.RequestTrace``) collects
        the per-phase anatomy; without one the call is an always-on
        ``serving.dispatch`` span. ``deadline`` (``time.monotonic``)
        sheds the request in the batch queue."""
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError(
                "instances must be a list of inputs, got a scalar")
        t0 = time.perf_counter()
        span_cm = (tracing.span("serving.dispatch", model=self.name,
                                track=self.track, version=self.version,
                                rows=int(x.shape[0]))
                   if rt is None else contextlib.nullcontext())
        with span_cm:
            if self._batcher is not None:
                try:
                    result = self._batcher.submit(x, rt=rt,
                                                  deadline=deadline)
                except RuntimeError as e:
                    if "batcher stopped" not in str(e) \
                            or not self._batcher._graceful_stop:
                        raise
                    # straggler: a handler resolved this model just
                    # before a version swap stopped its batcher
                    # gracefully; the retired copy still serves, so run
                    # direct (a hard stop, the server's shutdown, still
                    # refuses)
                    tw = time.time()
                    out = self._run(x)
                    result = out, 1000 * (time.perf_counter() - t0)
                    if rt is not None:
                        rt.phase("device", tw)
            else:
                tw = time.time()
                out = self._run(x)
                result = out, 1000 * (time.perf_counter() - t0)
                if rt is not None:
                    rt.phase("device", tw)
        elapsed = time.perf_counter() - t0
        _REQUEST_SECONDS.labels(self.name, self.track).observe(
            elapsed,
            trace_id=rt.exemplar(elapsed) if rt is not None else None)
        return result

    def predict_timed(self, instances):
        out, ms = self.predict_raw(instances)
        return out.tolist(), ms

    def close(self, graceful=False):
        if self._batcher is not None:
            self._batcher.stop(graceful=graceful)


def _decode_tensor(t):
    """``{"dtype", "shape", "b64"}`` → ndarray; malformed → ValueError
    (400: every defect here is the caller's)."""
    if not isinstance(t, dict):
        raise ValueError("tensor must be an object")
    dtype = t.get("dtype")
    if dtype not in TENSOR_DTYPES:
        raise ValueError(f"tensor.dtype must be one of "
                         f"{sorted(TENSOR_DTYPES)}, got {dtype!r}")
    shape = t.get("shape")
    if not isinstance(shape, list) or not shape \
            or not all(isinstance(d, int) and d >= 0 for d in shape):
        raise ValueError("tensor.shape must be a list of ints")
    data = base64.b64decode(t.get("b64") or "", validate=True)
    want = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if len(data) != want:
        raise ValueError(
            f"tensor data is {len(data)} bytes, shape×dtype needs {want}")
    return np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder("<"))\
        .reshape(shape)


def _encode_tensor_view(x):
    """ndarray → ``(dtype_name, shape, little-endian memoryview)``,
    aliasing a native little-endian contiguous array's buffer (no byte
    copy); a dtype outside ``TENSOR_DTYPES`` goes out as float32."""
    x = np.ascontiguousarray(x)
    if x.dtype.name not in TENSOR_DTYPES:
        x = x.astype(np.float32)
    if x.dtype.byteorder == ">" or (
            x.dtype.byteorder == "=" and sys.byteorder == "big"):
        # native-order dtypes report '=' on any host: a big-endian host
        # is caught through sys.byteorder
        x = x.astype(x.dtype.newbyteorder("<"))
    if x.size == 0:
        # memoryview cannot cast a view with a zero in its shape
        return x.dtype.name, list(x.shape), memoryview(b"")
    return x.dtype.name, list(x.shape), memoryview(x).cast("B")


def _encode_tensor_bytes(x):
    """ndarray → ``(dtype_name, shape, little-endian bytes)``."""
    dtype, shape, view = _encode_tensor_view(x)
    return dtype, shape, view.tobytes()


def _encode_tensor(x):
    dtype, shape, view = _encode_tensor_view(x)
    return {"dtype": dtype, "shape": shape,
            "b64": base64.b64encode(view).decode()}


def _parse_tensor_headers(headers):
    """``X-Tensor-Dtype``/``X-Tensor-Shape`` → (little-endian np.dtype,
    shape list); malformed → ValueError (400, never 500)."""
    dtype = (headers.get("X-Tensor-Dtype") or "").strip()
    if dtype not in TENSOR_DTYPES:
        raise ValueError(f"X-Tensor-Dtype must be one of "
                         f"{sorted(TENSOR_DTYPES)}, got {dtype!r}")
    raw = (headers.get("X-Tensor-Shape") or "").strip()
    if not raw:
        raise ValueError("X-Tensor-Shape header required "
                         "(comma-separated dims, e.g. '8,224,224,3')")
    try:
        shape = [int(d) for d in raw.split(",")]
    except ValueError:
        raise ValueError("X-Tensor-Shape must be comma-separated "
                         f"ints, got {raw!r}") from None
    if any(d < 0 for d in shape):
        raise ValueError(f"X-Tensor-Shape dims must be >= 0, got {raw!r}")
    return np.dtype(dtype).newbyteorder("<"), shape


def _decode_tensor_stream(headers, rfile, length, rt=None):
    """An ``application/x-tensor`` body → ``(ndarray, decode_seconds)``:
    ``np.frombuffer`` over the bytes read off the socket, no JSON and no
    base64. Malformed → ValueError (400). ``rt`` records the
    ``http.read``/``decode`` phases; ``decode_seconds`` leaves the
    socket read out, so ``serving_decode_seconds{format="binary"}``
    measures the same leg as the JSON formats."""
    t0 = time.perf_counter()
    dtype, shape = _parse_tensor_headers(headers)
    want = int(np.prod(shape)) * dtype.itemsize
    if length != want:
        raise ValueError(f"Content-Length is {length} bytes, "
                         f"shape×dtype needs {want}")
    t_read = time.time()
    read_s = time.perf_counter()
    data = rfile.read(length) if length else b""
    read_s = time.perf_counter() - read_s
    if len(data) != length:
        raise ValueError(f"body is {len(data)} bytes, "
                         f"Content-Length said {length}")
    if rt is not None:
        rt.phase("http.read", t_read)
    t_dec = time.time()
    arr = np.frombuffer(data, dtype=dtype).reshape(shape)
    if rt is not None:
        rt.phase("decode", t_dec, format="binary")
    return arr, time.perf_counter() - t0 - read_s


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


def decode_json_predict(raw):
    """A JSON predict body (the ``instances`` and b64 ``tensor``
    contracts) → ``(ndarray, fmt)``, the list → ndarray step included so
    the decode metric covers the whole body → ndarray cost. Malformed →
    ValueError/KeyError/TypeError (400)."""
    req = json.loads(raw or b"{}")
    if "tensor" in req:
        return _decode_tensor(req["tensor"]), "b64"
    return np.asarray(req["instances"]), "json"


def encode_predict_response(out, fmt, infer_ms, version):
    """One predict result → ``(body_parts, extra_headers,
    content_type)``; the transport writes the parts separately (its
    Content-Length their summed lengths), the binary payload a
    memoryview aliasing the result array."""
    common = (("X-Inference-Time-Ms", f"{infer_ms:.1f}"),
              ("X-Served-Version", str(version)))
    if fmt == "binary":
        dtype, shape, view = _encode_tensor_view(out)
        return [view], (
            ("X-Tensor-Dtype", dtype),
            ("X-Tensor-Shape", ",".join(str(d) for d in shape)),
            *common), "application/x-tensor"
    if fmt == "b64":
        payload = {"tensor": _encode_tensor(out)}
    else:
        payload = {"predictions": out.tolist()}
    return [json.dumps(payload).encode()], common, "application/json"


def _residency(model):
    return {
        "managed": model._managed,
        "loaded": model.loaded,
        "resident_bytes": model.resident_bytes
        if model._managed else None,
        "loads": model.loads,
        "evictions": model.evictions,
    }


class ModelServer:
    """Registry + HTTP server. ``server.register("mnist", fn)`` or
    ``server.register_generator("lm", engine)``, then
    ``server.start(port)``; the JAX package's clients and router work
    unchanged.

    ``budget_bytes`` bounds the device bytes of MANAGED models
    (``register_loadable``): a predict on an unloaded model loads it,
    evicting least-recently-used managed models until it fits.
    ``device`` is where the models this server builds run unless a
    registration names another (None: the card)."""

    def __init__(self, budget_bytes=None, stream_group=32, device=None):
        self._models = {}
        self._generators = {}     # name -> GenerationEngine
        self._httpd = None
        self._thread = None
        self._transport = None    # serving_async.AsyncTransport
        self._exporter = None
        self.transport = None
        self.draining = False     # begin_drain() flips healthz so the
        #                           router stops routing here
        self.budget_bytes = budget_bytes
        self.device = device
        # rows coalesced per device call on :predictStream
        self.stream_group = stream_group
        # RLock: register_loadable holds it across its preload's
        # _ensure_loaded, so pending/swap/retire are atomic against
        # concurrent loads and /v1/models reads
        self._residency_lock = threading.RLock()
        self._pending = []     # preloading models, budget-counted
        # displaced versions: an in-flight request that took the old
        # handle before the flip may lazily RELOAD it after the unload,
        # so retired models stay budget-counted (and go first)
        self._retired = []
        # canaries: name -> {"model", "weight"}; the rng is injectable
        # so tests can drive the split
        self._canaries = {}
        self._canary_rng = random.Random()

    def _model(self, name, version, kwargs, **mode):
        kwargs.setdefault("device", self.device)
        return ServedModel(name, version=version, **mode, **kwargs)

    def register(self, name, predict_fn, version=1, **model_kwargs):
        old = self._models.get(name)
        self._models[name] = self._model(name, version, model_kwargs,
                                         predict_fn=predict_fn)
        if old is not None:
            # graceful: queued predicts on the displaced model finish
            old.close(graceful=True)

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

    def recorders(self, name):
        """The flight recorders of engine ``name`` (None if no such
        engine): its iteration ring and, on the async transport, the
        loop's ``http.loop`` ring."""
        engine = self._generators.get(name)
        if engine is None:
            return None
        rings = [engine.trace]
        if self._transport is not None:
            rings.append(self._transport.trace)
        return rings

    def register_loadable(self, name, make_fn, params, version=1,
                          preload=False, **model_kwargs):
        """Register a residency-managed model: ``make_fn(params, x)`` is
        the predict callable, ``params`` the HOST tree (float, or
        ``quantize.quantize_tree``'s). The weights go to the device on
        the first predict (or now, with ``preload``) and can be evicted.

        Re-registering a served name with ``preload`` loads the new
        version BEFORE the swap (the old one serves until then) and
        flips traffic in one dict assignment; the displaced version's
        queued work drains before its batcher stops, and its device copy
        is unloaded."""
        model = self._model(name, version, model_kwargs, make_fn=make_fn,
                            host_params=params)
        model._ensure = self._ensure_loaded
        # ONE lock scope for read-old → preload → flip → retire: the
        # incoming copy is budget-counted (pending) through its preload,
        # and the displaced copy moves to _retired AT the flip
        with self._residency_lock:
            old = self._models.get(name)
            if preload:
                self._pending.append(model)
                try:
                    self._ensure_loaded(model)
                except Exception:
                    self._pending.remove(model)
                    model.close()      # don't leak the batcher thread
                    raise
                self._models[name] = model   # atomic traffic flip
                self._pending.remove(model)
            else:
                self._models[name] = model
            if old is not None:
                self._mark_retired(old)
        if old is not None:
            self._drain_and_unload(old)
        return model

    def models(self):
        return dict(self._models)

    # ----------------------------------------------------- canaries
    def register_canary(self, name, make_fn, params, version,
                        weight=0.1, preload=True, **model_kwargs):
        """Deploy ``version`` as a CANARY of served name ``name``: a
        ``weight`` share of its predict traffic routes to it until
        :meth:`promote_canary` or :meth:`rollback_canary`. Responses
        carry ``X-Served-Version``. The canary is residency-managed like
        any loadable model."""
        if name not in self._models:
            raise KeyError(f"no stable model {name!r} to canary")
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"weight must be in [0, 1], got {weight}")
        model = self._model(name, version, model_kwargs, make_fn=make_fn,
                            host_params=params)
        model.track = "canary"     # metric/trace attribution
        model._ensure = self._ensure_loaded
        with self._residency_lock:
            if preload:
                # load BEFORE publishing: no traffic reaches a canary
                # that is still loading or whose load fails
                self._pending.append(model)
                try:
                    self._ensure_loaded(
                        model, protect=self._models.get(name))
                except Exception:
                    model.close()   # don't leak the batcher thread
                    raise           # nothing published
                finally:
                    self._pending.remove(model)
            prev = self._canaries.pop(name, None)
            self._canaries[name] = {"model": model, "weight": weight}
        if prev is not None:
            self._mark_retired(prev["model"])
            self._drain_and_unload(prev["model"])
        return model

    def set_canary_weight(self, name, weight):
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"weight must be in [0, 1], got {weight}")
        with self._residency_lock:
            self._canaries[name]["weight"] = weight

    def promote_canary(self, name):
        """All traffic to the canary; the previous stable version is
        drained and retired like a version transition."""
        with self._residency_lock:
            entry = self._canaries.pop(name)
            model = entry["model"]
            model.track = "stable"
            old = self._models.get(name)
            self._models[name] = model
            if old is not None:
                self._mark_retired(old)
        if old is not None:
            self._drain_and_unload(old)
        return model

    def rollback_canary(self, name):
        """Discard the canary; the stable version serves untouched. The
        canary is retired (an in-flight request that routed to it may
        lazily reload it, and those bytes stay budget-visible)."""
        with self._residency_lock:
            entry = self._canaries.pop(name)
            self._mark_retired(entry["model"])
        self._drain_and_unload(entry["model"])

    def _route(self, name, model):
        """Stable or canary for one predict call."""
        entry = self._canaries.get(name)
        if entry is not None \
                and self._canary_rng.random() < entry["weight"]:
            return entry["model"]
        return model

    def _mark_retired(self, old):
        """A displaced managed model becomes retired: budget-counted and
        evictable, one entry per name. Called inside the flip's lock
        scope (the RLock re-enters)."""
        if not old._managed:
            return
        with self._residency_lock:
            for prev in [m for m in self._retired
                         if m.name == old.name and m is not old]:
                prev.unload()
                self._retired.remove(prev)
            self._retired.append(old)

    def _drain_and_unload(self, old):
        """The one drain path of a displaced model (version transition,
        canary promote/replace/rollback): stop accepting, let the queued
        work finish — joining the batcher BEFORE the unload, so a queued
        straggler never cold-reloads the copy being freed — then drop
        the device copy. If the join times out the unload is skipped
        (the thread may still hold the tree): the copy stays
        budget-counted and first in line for eviction, and
        ``serving_drain_timeout_total`` counts it."""
        old.close(graceful=True)
        if old._batcher is not None:
            old._batcher.thread.join(timeout=30)
            if old._batcher.thread.is_alive():
                _DRAIN_TIMEOUT_TOTAL.labels(old.name).inc()
                log.warning(
                    "model %s v%s: batcher did not drain within 30s; "
                    "skipping unload (copy stays evictable-but-"
                    "resident until the thread exits)",
                    old.name, old.version)
                return
        if old._managed:
            with self._residency_lock:
                old.unload()

    # --------------------------------------------------- residency
    def _all_managed(self):
        """Every model that can hold device bytes (registry, pending
        transitions, retired stragglers, canaries)."""
        return [*self._models.values(), *self._pending, *self._retired,
                *(c["model"] for c in self._canaries.values())]

    def resident_bytes(self):
        with self._residency_lock:
            seen, total = set(), 0
            for m in self._all_managed():
                if m._managed and m.loaded and id(m) not in seen:
                    seen.add(id(m))
                    total += m.resident_bytes
            return total

    def _ensure_loaded(self, model, protect=None):
        """Make ``model`` resident under the byte budget, evicting LRU
        managed models as needed, and return its device tree pinned.
        ``protect`` is unevictable for this load; loading a canary
        protects the stable it shadows. Serialized: two concurrent loads
        would both pass the budget check."""
        with self._residency_lock:
            if protect is None:
                entry = self._canaries.get(model.name)
                if entry is not None and entry["model"] is model:
                    protect = self._models.get(model.name)
            if model.loaded:
                return model._dev_params
            budget = self.budget_bytes
            if budget is not None:
                if model.resident_bytes > budget:
                    raise ModelTooLargeError(
                        f"model {model.name} needs "
                        f"{model.resident_bytes} bytes; budget is "
                        f"{budget}")
                # pending (mid-transition) models count toward the
                # budget but are never victims
                pending = [m for m in self._pending
                           if m._managed and m.loaded
                           and m is not model]
                seen = set()
                candidates = []
                for m in self._all_managed():
                    if m._managed and m.loaded and m is not model \
                            and m is not protect \
                            and m not in self._pending \
                            and id(m) not in seen:
                        seen.add(id(m))
                        candidates.append(m)
                loaded = sorted(candidates, key=lambda m: m.last_used)
                if protect is not None and protect._managed \
                        and protect.loaded:
                    pending = [*pending, protect]
                in_use = sum(m.resident_bytes
                             for m in [*loaded, *pending])
                for victim in loaded:
                    if in_use + model.resident_bytes <= budget:
                        break
                    victim.unload()
                    in_use -= victim.resident_bytes
                if in_use + model.resident_bytes > budget:
                    # every victim is gone and it still does not fit:
                    # the rest is unevictable (mid-transition copies)
                    raise CapacityBusyError(
                        f"model {model.name} needs "
                        f"{model.resident_bytes} bytes but only "
                        f"{budget - in_use} are free "
                        f"({in_use} held, partly by an in-flight "
                        f"version transition); retry shortly")
            model.load()
            return model._dev_params

    # -------------------------------------------------------- HTTP

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
            rings = [tracing.TRACES]
            if query.get("engine") is not None:
                rings = self.recorders(query["engine"])
                if rings is None:
                    return 404, {"error": "model not found"}, (), json_ct
            if query.get("format") == "chrome":
                events = [e for r in rings
                          for e in r.chrome_trace(tid)["traceEvents"]]
                return (200, {"traceEvents": events,
                              "displayTimeUnit": "ms"}, (), json_ct)
            return (200, {"traces": [t for r in rings
                                     for t in r.traces(tid)]}, (),
                    json_ct)
        if parts == ["debug", "latency"]:
            return (200, tracing.latency_summary(
                tracing.TRACES.span_dicts(),
                path=query.get("path")), (), json_ct)
        if len(parts) == 3 and parts[:2] == ["v1", "models"]:
            model = self._models.get(parts[2])
            generator = self._generators.get(parts[2])
            if model is None and generator is None:
                return 404, {"error": "model not found"}, (), json_ct
            # an evicted managed model stays AVAILABLE (a predict
            # reloads it); residency tells the device truth
            canary = self._canaries.get(parts[2])
            version = model.version if model is not None \
                else generator.version
            payload = {"model_version_status": [{
                "version": str(version),
                "state": "AVAILABLE",
                "status": {"error_code": "OK", "error_message": ""},
            }]}
            if model is not None:
                payload["residency"] = _residency(model)
            if generator is not None:
                payload["generator"] = generator.snapshot()
            if canary is not None:
                payload["canary"] = {
                    "version": str(canary["model"].version),
                    "weight": canary["weight"],
                    **_residency(canary["model"])}
            return 200, payload, (), json_ct
        if parts == ["v1", "models"]:
            # both registries snapshotted under the lock: a deploy on
            # another thread must not resize them mid-iteration
            with self._residency_lock:
                model_items = list(self._models.values())
                canary_items = list(self._canaries.items())
            generator_items = sorted(self.generators().items())
            return 200, {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self.resident_bytes(),
                "models": [{
                    "name": m.name,
                    "version": str(m.version),
                    "state": "RESIDENT" if m.loaded else "EVICTED",
                    **_residency(m),
                } for m in model_items] + [{
                    "name": f"{name}@canary",
                    "version": str(c["model"].version),
                    "weight": c["weight"],
                    "state": "RESIDENT" if c["model"].loaded
                    else "EVICTED",
                    **_residency(c["model"]),
                } for name, c in canary_items],
                "generators": [{
                    "name": name,
                    "version": str(engine.version),
                    **engine.snapshot(),
                } for name, engine in generator_items]}, (), json_ct
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
                model = server._models.get(name)
                if model is None:
                    return self._send(404, {"error": "model not found"})
                # canary split: a weighted share of the traffic serves
                # from the canary version (resolved per request)
                model = server._route(name, model)
                rt = self._rt
                rt.attrs["model"] = name
                rt.attrs["track"] = model.track
                if verb == "predictStream":
                    return self._predict_stream(model, length)
                if verb != "predict":
                    return self._send(400, {"error": f"verb {verb}"})
                try:
                    deadline = parse_deadline(
                        self.headers.get("X-Request-Deadline-Ms"))
                except ValueError as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                ctype = (self.headers.get("Content-Type") or "") \
                    .split(";")[0].strip().lower()
                if ctype == "application/x-tensor":
                    # the raw buffer: dtype/shape in headers, no JSON
                    # and no base64 on either leg
                    return self._predict_binary(model, deadline, length)
                # 400 = the caller's fault (malformed body); 500 = ours
                try:
                    t_read = time.time()
                    raw = self.rfile.read(length) if length else b""
                    rt.phase("http.read", t_read)
                    t_dec = time.perf_counter()
                    tw_dec = time.time()
                    x, fmt = decode_json_predict(raw)
                except (ValueError, KeyError, TypeError) as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                _WIRE_FORMAT_TOTAL.labels(fmt).inc()
                _DECODE_SECONDS.labels(fmt).observe(
                    time.perf_counter() - t_dec)
                rt.phase("decode", tw_dec, format=fmt)
                result = self._predict_guarded(model, x, deadline)
                if result is None:
                    return      # the taxonomy's answer is sent
                # the success write stays outside the try: a client
                # reset mid-body must not send a second (500) answer
                out, infer = result
                t_enc = time.time()
                parts, extra, ctype = encode_predict_response(
                    out, fmt, infer, model.version)
                rt.phase("encode", t_enc, format=fmt)
                self._send(200, parts, extra, content_type=ctype)

            def _predict_guarded(self, model, x, deadline=None):
                """``predict_raw`` under the one error taxonomy
                (``classify_predict_error``) → ``(out, infer_ms)``, or
                None after sending the error answer."""
                try:
                    return model.predict_raw(x, rt=self._rt,
                                             deadline=deadline)
                except Exception as e:  # noqa: BLE001 — wire boundary
                    code, payload, extra = classify_predict_error(e)
                    self._send(code, payload, extra)
                return None

            def _predict_binary(self, model, deadline=None, length=0):
                """``application/x-tensor`` predict: the request's dtype
                and shape in ``X-Tensor-*``, the body the raw
                little-endian buffer, and the answer in the same
                format; the JSON route's error taxonomy."""
                try:
                    x, dec_s = _decode_tensor_stream(
                        self.headers, self.rfile, length, rt=self._rt)
                except (ValueError, TypeError) as e:
                    # drain the unread body first: closing with inbound
                    # bytes pending can reset away the 400
                    left = length
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 20))
                        if not chunk:
                            break
                        left -= len(chunk)
                    return self._send(400, {"error": f"bad request: {e}"})
                _WIRE_FORMAT_TOTAL.labels("binary").inc()
                _DECODE_SECONDS.labels("binary").observe(dec_s)
                result = self._predict_guarded(model, x, deadline)
                if result is None:
                    return      # the taxonomy's answer is sent
                out, infer = result
                t_enc = time.time()
                # the payload is a memoryview of the result, written
                # after the head: never joined into one buffer
                parts, extra, ctype = encode_predict_response(
                    out, "binary", infer, model.version)
                self._rt.phase("encode", t_enc, format="binary")
                self._send(200, parts, extra, content_type=ctype)

            def _predict_stream(self, model, length):
                """Batched, pipelined predict over one connection: the
                body is NDJSON (one ``{"instances"|"tensor"}`` request a
                line), the answer streams NDJSON results back in order,
                chunked. Consecutive same-shape lines coalesce into one
                device call of at most ``stream_group`` rows, and group
                k+1 is decoded and launched while group k's results are
                fetched."""
                def iter_lines(remaining):
                    # incremental: decode and dispatch start on the
                    # first line
                    while remaining > 0:
                        # limit EXACTLY remaining: one byte more would
                        # block on a last line without a newline
                        ln = self.rfile.readline(remaining)
                        if not ln:
                            return
                        remaining -= len(ln)
                        if remaining <= 0 and not ln.endswith(b"\n"):
                            # an unterminated last record, or one an
                            # understated Content-Length cut: the
                            # consumer decides by whether it parses
                            yield ("final_noeol", ln)
                            return
                        if ln.strip():
                            yield ln

                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Served-Version",
                                 str(model.version))
                sp = getattr(self, "_rt", None) or \
                    tracing.current_span()
                if sp is not None:
                    self.send_header("traceparent",
                                     tracing.format_traceparent(sp))
                self.end_headers()

                # a half-duplex client uploads the whole body before it
                # reads: results buffer until the ingest ends, then
                # stream out (device dispatch still overlaps the upload)
                out_buf = []
                ingesting = True

                def chunk(payload):
                    body = json.dumps(payload).encode() + b"\n"
                    framed = f"{len(body):X}\r\n".encode() + body + b"\r\n"
                    if ingesting:
                        out_buf.append(framed)
                    else:
                        if out_buf:
                            self.wfile.write(b"".join(out_buf))
                            out_buf.clear()
                        self.wfile.write(framed)

                GROUP = server.stream_group
                pending = collections.deque()

                def emit_done(slot):
                    """slot: ('err', msg) | (fut, rows, binaries)."""
                    if slot[0] == "err":
                        chunk({"error": slot[1]})
                        return
                    fut, rows, binaries = slot
                    try:
                        out = model.finalize(fut, sum(rows))
                    except Exception as e:  # noqa: BLE001 — wire
                        for _ in rows:
                            chunk({"error": f"inference failed: {e}"})
                        return
                    off = 0
                    for n, binary in zip(rows, binaries):
                        part = out[off:off + n]
                        off += n
                        chunk({"tensor": _encode_tensor(part)} if binary
                              else {"predictions": part.tolist()})

                group = []      # [(x, binary)] of one shape and dtype

                def flush_group():
                    if not group:
                        return
                    xs = [x for x, _ in group]
                    x = np.concatenate(xs, 0) if len(xs) > 1 else xs[0]
                    _BATCH_OCCUPANCY.labels(
                        model.name, model.track).observe(len(group))
                    try:
                        fut, _ = model.dispatch(x)
                        pending.append(
                            (fut, [g.shape[0] for g in xs],
                             [b for _, b in group]))
                    except Exception as e:  # noqa: BLE001 — per-group
                        for _ in group:
                            pending.append(
                                ("err", f"inference failed: {e}"))
                    group.clear()
                    # fetch the PREVIOUS group while this one runs
                    while len(pending) > 1:
                        emit_done(pending.popleft())

                for ln in iter_lines(length):
                    maybe_truncated = False
                    if isinstance(ln, tuple):  # ("final_noeol", line)
                        ln = ln[1]
                        if not ln.strip():
                            continue
                        maybe_truncated = True
                    try:
                        t_dec = time.perf_counter()
                        req = json.loads(ln)
                        if "tensor" in req:
                            binary = True
                            x = _decode_tensor(req["tensor"])
                        else:
                            binary = False
                            x = np.asarray(req["instances"])
                            if x.ndim == 0:
                                raise ValueError("scalar instances")
                        fmt = "b64" if binary else "json"
                        _WIRE_FORMAT_TOTAL.labels(fmt).inc()
                        _DECODE_SECONDS.labels(fmt).observe(
                            time.perf_counter() - t_dec)
                    except Exception as e:  # noqa: BLE001 — per-line
                        flush_group()
                        if maybe_truncated:
                            # an unparseable last fragment without a
                            # newline: say the body was cut
                            pending.append((
                                "err",
                                "truncated body: Content-Length ended "
                                f"mid-line after {len(ln)} bytes"))
                        else:
                            pending.append(("err", f"bad request: {e}"))
                        continue
                    if group and (
                            x.shape[1:] != group[0][0].shape[1:]
                            or x.dtype != group[0][0].dtype
                            or sum(g.shape[0] for g, _ in group)
                            + x.shape[0] > GROUP):
                        flush_group()
                    group.append((x, binary))
                flush_group()
                ingesting = False
                if out_buf:
                    self.wfile.write(b"".join(out_buf))
                    out_buf.clear()
                while pending:
                    emit_done(pending.popleft())
                self.wfile.write(b"0\r\n\r\n")   # chunked terminator

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
        ``transport`` picks the wire engine: ``"threaded"`` (one handler
        thread per connection) or ``"async"`` (``serving_async``: one
        ``selectors`` event loop, non-blocking accept/read/write,
        keep-alive multiplexing, zero-copy ``application/x-tensor``
        reads). The default comes from ``SERVING_TRANSPORT``, else
        threaded. Both speak the same wire contract."""
        transport = (transport or os.environ.get("SERVING_TRANSPORT")
                     or "threaded").strip().lower()
        if transport == "async":
            from . import serving_async
            self._transport = serving_async.AsyncTransport(
                self, host=host, port=port)
            actual = self._transport.start()
        elif transport == "threaded":
            self._httpd = ThreadingHTTPServer((host, port),
                                              self._handler())
            self._httpd.daemon_threads = True
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="model-server")
            self._thread.start()
            actual = self._httpd.server_address[1]
        else:
            raise ValueError(f"unknown serving transport "
                             f"{transport!r} (threaded | async)")
        self.transport = transport
        # fleet telemetry: no-op when no shard directory resolves; one
        # exporter a server, however many transports it listens on
        if self._exporter is None:
            from ..obs import export as obs_export
            self._exporter = obs_export.start_exporter()
        return actual

    def begin_drain(self):
        """Soft drain: healthz flips to ``draining``, every engine
        evicts its slots gracefully (open streams get a ``draining``
        frame) and further ``:generate`` submits get a clean 503. The
        async transport then reaps its idle keep-alive connections and
        closes every further response's; health probes keep answering."""
        self.draining = True
        for engine in self.generators().values():
            engine.begin_drain()
        if self._transport is not None:
            self._transport.drain()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        # the loop and its executor threads end before the models close
        if self._transport is not None:
            self._transport.stop()
            self._transport = None
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        # canaries own batcher threads too; retired and pending copies
        # were closed when displaced
        with self._residency_lock:
            models = [*self._models.values(),
                      *(c["model"] for c in self._canaries.values())]
        for model in models:
            model.close()
        # the batcher threads end before the caller goes on: a daemon
        # thread still inside torch when the interpreter exits aborts
        # the process (``terminate called without an active exception``)
        for model in models:
            if model._batcher is not None:
                model._batcher.thread.join(timeout=30)
        for engine in self.generators().values():
            engine.close()
