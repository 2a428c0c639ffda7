"""In-process span tracing, dependency-free — the port's own copy of
``kubeflow_tpu/obs/tracing.py`` (the port imports nothing of the JAX
package), booking into the port's ``obs/metrics.py`` knobs.

- ``span(name, **attrs)``: context manager. Parent/child linkage rides
  a contextvar, so nesting works across any call depth in one thread.
- W3C trace context: ``parse_traceparent`` / ``format_traceparent``
  implement the ``00-<trace-id>-<parent-id>-<flags>`` header; the
  model server extracts it on ingress and injects it on responses, so
  an external client stitches the server's spans into its own trace.
- ``TraceBuffer``: bounded ring buffer of COMPLETED spans. ``traces()``
  groups by trace id for the ``/debug/traces`` JSON view;
  ``chrome_trace()`` emits Chrome trace-event format, openable in
  Perfetto — the platform timeline beside the device timeline of
  ``compute/profiler.py``. A ``TraceBuffer`` given a ``thread`` is
  also a flight recorder: ``record()`` books a span as a plain tuple
  (the generation engine's iteration phases, the async transport's loop
  passes), stamped with ``time.time()`` as every span here is — the
  wall clock the profiler stamps device events on, so the spans line up
  with kernels.
- ``RequestTrace``: per-request latency anatomy with head sampling and
  an always-keep-slow tail policy. Phases (``http.read``, ``decode``,
  ``generate.queue_wait``, ``generate.prefill``, ``generate.decode``,
  ``http.write``) are recorded as plain tuples — a sampled-out request
  allocates NO ``Span`` objects — and only materialize into the ring
  when the request is head-sampled in (``OBS_TRACE_SAMPLE``), turned
  out slow (``OBS_TRACE_SLOW_MS``), or errored. ``latency_summary``
  decomposes p50/p95/p99 per phase for ``/debug/latency``.
"""

import contextvars
import hashlib
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager

from . import metrics as obs_metrics

_CURRENT = contextvars.ContextVar("kubeflow_tpu_torch_obs_span",
                                  default=None)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(header):
    """W3C traceparent → (trace_id, parent_span_id) or None.

    Rejects malformed headers, the forbidden version ``ff``, and
    all-zero ids (the spec's "invalid" sentinels) — a bad header means
    "start a fresh trace", never an exception on the request path."""
    if not header:
        return None
    mo = _TRACEPARENT_RE.match(header.strip().lower())
    if mo is None:
        return None
    version, trace_id, span_id, _flags = mo.groups()
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


def format_traceparent(span):
    return f"00-{span.trace_id}-{span.span_id}-01"


def derive_trace_id(*parts):
    """Deterministic 32-hex trace id from identity parts. The fleet
    trace-stitching contract: every process that knows a workload's
    (kind, namespace, name) derives the SAME trace id, so controller
    spans, scheduler spans and worker spans land on one timeline
    without any id having to travel through the store."""
    digest = hashlib.sha256("\x1f".join(str(p) for p in parts)
                            .encode()).hexdigest()[:32]
    # the spec's all-zero trace id is invalid; astronomically unlikely,
    # but a derived id must never be the sentinel
    return digest if set(digest) != {"0"} else "1" + digest[1:]


def derive_span_id(*parts):
    """Deterministic 16-hex span id (same derivation, span width)."""
    digest = hashlib.sha256(("span:" + "\x1f".join(str(p) for p in parts))
                            .encode()).hexdigest()[:16]
    return digest if set(digest) != {"0"} else "1" + digest[1:]


def workload_traceparent(kind, namespace, name, epoch=0):
    """The ``TRACEPARENT`` value a controller injects into a workload's
    pod env (and uses for its own spans about that workload): trace id
    from the workload identity, parent span id from identity + epoch
    (gang generation / launch batch), so a restarted gang's spans hang
    off a fresh parent on the SAME trace."""
    return (f"00-{derive_trace_id(kind, namespace, name)}"
            f"-{derive_span_id(kind, namespace, name, epoch)}-01")


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "attrs", "status", "thread")

    def __init__(self, name, trace_id, parent_id, attrs, start=None,
                 span_id=None):
        self.name = name
        self.trace_id = trace_id
        # explicit ids/times let RequestTrace materialize a span
        # post-hoc (the keep decision needs the full duration first)
        self.span_id = span_id or os.urandom(8).hex()
        self.parent_id = parent_id
        self.start = time.time() if start is None else start
        self.end = None
        self.attrs = attrs
        self.status = "ok"
        self.thread = threading.current_thread().name

    @property
    def duration(self):
        return ((self.end if self.end is not None else time.time())
                - self.start)

    def to_dict(self):
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_ms": round(self.duration * 1000, 3),
            "status": self.status,
            "thread": self.thread,
            "attrs": {k: v for k, v in self.attrs.items()},
        }


class TraceBuffer:
    """Bounded ring buffer of completed spans (oldest evicted first).

    A flight recorder (``thread`` given: the one thread whose spans
    it keeps, an engine's or a transport loop's) books with
    :meth:`record` only, never :meth:`add`: a plain
    ``(name, start, end, attrs)`` tuple,
    wall-clock seconds, so recording costs a clock read and an append.
    Its ``Span`` objects exist only when a reader asks (:meth:`spans`),
    each the child of the latest-starting span that encloses it, on one
    trace id derived from ``thread``, on that thread's lane."""

    def __init__(self, capacity=4096, thread=None):
        self._spans = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.thread = thread
        self.trace_id = derive_trace_id("recorder", thread) \
            if thread is not None else None

    def add(self, span):
        with self._lock:
            self._spans.append(span)

    def record(self, name, start, end, attrs=None):
        """Book one completed span of the recorder's thread."""
        with self._lock:
            self._spans.append((name, start, end, attrs))

    def records(self, since=None, until=None):
        """The recorded tuples, oldest first; with ``since``/``until``
        (wall seconds) only those that overlap ``[since, until]``."""
        with self._lock:
            snapshot = list(self._spans)
        return [r for r in snapshot
                if (since is None or r[2] >= since)
                and (until is None or r[1] <= until)]

    def clear(self):
        with self._lock:
            self._spans.clear()

    def _materialize(self, recs):
        """Recorded tuples → ``Span``s, each parented by the innermost
        span that encloses it."""
        out, stack = [], []
        for name, start, end, attrs in sorted(
                recs, key=lambda r: (r[1], -r[2])):
            while stack and stack[-1].end < end:
                stack.pop()
            s = Span(name, self.trace_id,
                     stack[-1].span_id if stack else None,
                     dict(attrs) if attrs else {}, start=start,
                     span_id=derive_span_id(self.trace_id, name,
                                            repr(start)))
            s.end = end
            s.thread = self.thread
            stack.append(s)
            out.append(s)
        return out

    def spans(self, trace_id=None):
        with self._lock:
            snapshot = list(self._spans)
        if self.thread is not None:
            snapshot = self._materialize(snapshot)
        if trace_id is not None:
            snapshot = [s for s in snapshot if s.trace_id == trace_id]
        return snapshot

    def span_dicts(self, trace_id=None):
        """Completed spans as dicts — the shape ``latency_summary``
        and the fleet merge operate on."""
        return [s.to_dict() for s in self.spans(trace_id)]

    def traces(self, trace_id=None, limit=50):
        """Group completed spans by trace id, most recently finished
        trace first, spans within a trace in start order."""
        groups = {}
        for s in self.spans(trace_id):
            groups.setdefault(s.trace_id, []).append(s)
        out = []
        for tid, spans in groups.items():
            spans.sort(key=lambda s: s.start)
            out.append({"trace_id": tid,
                        "spans": [s.to_dict() for s in spans]})
        # recency = latest end time in the trace (duration is in ms)
        out.sort(key=lambda t: max(sp["start"] + sp["duration_ms"] / 1000
                                   for sp in t["spans"]), reverse=True)
        return out[:limit]

    def chrome_trace(self, trace_id=None):
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing):
        one complete ('X') event per span, microsecond timestamps."""
        events = []
        for s in self.spans(trace_id):
            events.append({
                "name": s.name,
                "cat": s.trace_id,
                "ph": "X",
                "ts": s.start * 1e6,
                "dur": s.duration * 1e6,
                "pid": os.getpid(),
                "tid": s.thread,
                "args": {**s.attrs, "span_id": s.span_id,
                         "parent_id": s.parent_id,
                         "status": s.status},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


#: the process-global buffer ``/debug/traces`` serves
TRACES = TraceBuffer()


def current_span():
    return _CURRENT.get()


@contextmanager
def span(name, traceparent=None, buffer=None, **attrs):
    """Open a span. An explicit valid ``traceparent`` wins — the
    caller is deliberately pointing at another trace (a controller
    dropping a marker on a workload's derived trace from inside its
    own reconcile span); otherwise the in-process parent (contextvar)
    continues; otherwise a fresh trace starts. The completed span
    lands in ``buffer`` (default: the global ring)."""
    remote = parse_traceparent(traceparent)
    parent = _CURRENT.get()
    if remote is not None:
        trace_id, parent_id = remote
    elif parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = os.urandom(16).hex(), None
    s = Span(name, trace_id, parent_id, dict(attrs))
    token = _CURRENT.set(s)
    try:
        yield s
    except BaseException as e:
        s.status = "error"
        s.attrs.setdefault("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        s.end = time.time()
        _CURRENT.reset(token)
        (TRACES if buffer is None else buffer).add(s)


# ------------------------------------------------- request anatomy

#: the latency-anatomy phase vocabulary (/debug/latency groups by
#: them), the same as the JAX package's so fleet summaries merge;
#: the port's model server emits the http/decode and generate legs
PHASE_NAMES = ("http.read", "decode", "batch.queue_wait",
               "batch.dispatch", "device", "encode", "http.write",
               # the :generate anatomy (compute/generate.py): queue →
               # prefill → token-streaming decode tail; disjoint legs
               # of a generation request, so the phase sum stays
               # meaningful under ?path=:generate
               "generate.queue_wait", "generate.prefill",
               "generate.decode")


def trace_sample_rate():
    """``OBS_TRACE_SAMPLE``: fraction of request traces head-sampled
    into the span ring (default 1.0 = everything; 0 = only the slow
    tail). Read per request so operators can flip it live."""
    return obs_metrics.env_float("OBS_TRACE_SAMPLE", 1.0)


def slow_keep_ms():
    """``OBS_TRACE_SLOW_MS``: requests at least this slow are kept
    even when head sampling dropped them (the always-keep-slow tail —
    the p99 outliers are exactly the traces worth reading). Negative
    disables the tail policy."""
    return obs_metrics.env_float("OBS_TRACE_SLOW_MS", 250.0)


def head_sampled(trace_id, rate):
    """Deterministic head-sampling decision from the trace id: every
    hop of one trace (client, web tier, model server) computes the
    same verdict, so a kept trace is complete rather than a random
    subset of its spans."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        return int(trace_id[-8:], 16) < rate * 0x100000000
    except ValueError:
        return True


class RequestTrace:
    """One request's latency anatomy + keep policy.

    NOT a context manager on the thread contextvar: phases may be
    recorded from other threads (the serving batcher records
    ``batch.queue_wait``/``batch.dispatch``/``device`` from its loop
    thread while the HTTP thread owns the request). Phases are plain
    tuples; ``Span`` objects exist only if ``finish()`` decides to
    keep the request — head-sampled in, slower than the tail
    threshold, or errored. A sampled-out fast request therefore costs
    one small object and a few tuple appends, never ring space.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "attrs", "status", "sampled", "slow_s", "kept",
                 "_phases")

    def __init__(self, name, traceparent=None, sample_rate=None,
                 slow_ms=None, **attrs):
        remote = parse_traceparent(traceparent)
        if remote is not None:
            self.trace_id, self.parent_id = remote
        else:
            self.trace_id, self.parent_id = os.urandom(16).hex(), None
        self.span_id = os.urandom(8).hex()
        self.name = name
        self.start = time.time()
        self.attrs = dict(attrs)
        self.status = "ok"
        rate = trace_sample_rate() if sample_rate is None else sample_rate
        self.sampled = head_sampled(self.trace_id, rate)
        self.slow_s = (slow_keep_ms() if slow_ms is None
                       else slow_ms) / 1000.0
        self.kept = None          # decided by finish()
        self._phases = []         # (name, start, end, attrs|None)

    def phase(self, name, start, end=None, **attrs):
        """Record one phase interval (wall-clock seconds). Appends are
        GIL-atomic, so the batcher thread and the HTTP thread may both
        record without a lock."""
        self._phases.append((name, start,
                             time.time() if end is None else end,
                             attrs or None))

    def keep(self, duration_ms):
        return (self.sampled or self.status == "error"
                or (self.slow_s >= 0
                    and duration_ms >= self.slow_s * 1000.0))

    def exemplar(self, duration_s):
        """Trace id to attach as an OpenMetrics exemplar to a
        histogram observation of ``duration_s`` — only when this
        request will be visible in ``/debug/traces`` (an exemplar
        pointing at a dropped trace is a dead link)."""
        return self.trace_id if self.keep(duration_s * 1000.0) else None

    def _emit_phases(self, buffer=None):
        buf = TRACES if buffer is None else buffer
        for name, s, e, attrs in self._phases:
            ps = Span(name, self.trace_id, self.span_id,
                      dict(attrs) if attrs else {}, start=s)
            ps.end = e
            buf.add(ps)

    def finish(self, end=None, buffer=None):
        """Close the request: decide keep (head sample OR slow tail OR
        error) and, if kept, materialize the phase spans plus the root
        span into the ring. Returns whether the trace was kept."""
        end = time.time() if end is None else end
        self.kept = self.keep((end - self.start) * 1000.0)
        if self.kept:
            self._emit_phases(buffer)
            root = Span(self.name, self.trace_id, self.parent_id,
                        self.attrs, start=self.start,
                        span_id=self.span_id)
            root.status = self.status
            root.end = end
            (TRACES if buffer is None else buffer).add(root)
        return self.kept

    def late_phase(self, name, start, end=None, buffer=None, **attrs):
        """Record a phase that happens after ``finish()`` — the
        ``http.write`` leg runs after the middleware closed the root.
        Materialized directly (same keep verdict as the root)."""
        if not self.kept:
            return
        ps = Span(name, self.trace_id, self.span_id,
                  dict(attrs), start=start)
        ps.end = time.time() if end is None else end
        (TRACES if buffer is None else buffer).add(ps)

    @contextmanager
    def active(self, buffer=None):
        """The web-middleware shape. Head-sampled IN: a real root span
        rides the contextvar so nested ``span()`` children (reconciles,
        dispatches) link exactly as before sampling existed. Sampled
        OUT: nothing is allocated; on exit ``finish()`` still keeps the
        request if it turned out slow or errored (the root is
        materialized post-hoc; contextvar children opened meanwhile
        started their own traces — the documented cost of dropping the
        head sample)."""
        if self.sampled:
            s = Span(self.name, self.trace_id, self.parent_id,
                     self.attrs, start=self.start, span_id=self.span_id)
            token = _CURRENT.set(s)
            try:
                yield s
            except BaseException as e:
                self.status = s.status = "error"
                s.attrs.setdefault("error", f"{type(e).__name__}: {e}")
                raise
            finally:
                s.end = time.time()
                _CURRENT.reset(token)
                s.status = self.status if s.status == "ok" else s.status
                self._emit_phases(buffer)
                (TRACES if buffer is None else buffer).add(s)
                self.kept = True
        else:
            try:
                yield None
            except BaseException as e:
                self.status = "error"
                self.attrs.setdefault("error",
                                      f"{type(e).__name__}: {e}")
                raise
            finally:
                self.finish(buffer=buffer)


# ----------------------------------------------- latency decomposition

def _pctl(sorted_values, q):
    return sorted_values[min(len(sorted_values) - 1,
                             int(q * len(sorted_values)))]


def _stats(durations):
    durations = sorted(durations)
    return {"count": len(durations),
            "mean_ms": round(sum(durations) / len(durations), 3),
            "p50_ms": round(_pctl(durations, 0.50), 3),
            "p95_ms": round(_pctl(durations, 0.95), 3),
            "p99_ms": round(_pctl(durations, 0.99), 3)}


def latency_summary(span_dicts, path=None, phases=PHASE_NAMES):
    """Decompose request latency per phase from completed span dicts
    (``TraceBuffer.span_dicts()`` locally, the merged fleet spans on
    the metrics hub) — the ``/debug/latency`` payload.

    ``path``: restrict to traces whose root (``http ...``) span name
    contains the substring (e.g. ``:predict`` to exclude web-tier
    traffic). Phases with a ``format`` attr additionally aggregate
    under ``<phase>{format="..."}`` keys so decode cost splits by wire
    format. ``phase_p50_sum_ms``/``phase_mean_sum_ms`` sum the base
    phases only — the number to hold against the request p50 (the gap
    between them is unattributed framework overhead)."""
    if path is not None:
        keep = {s.get("trace_id") for s in span_dicts
                if (s.get("name") or "").startswith("http ")
                and path in s["name"]}
        span_dicts = [s for s in span_dicts
                      if s.get("trace_id") in keep]
    groups = {}
    requests = []
    for s in span_dicts:
        name = s.get("name") or ""
        dur = s.get("duration_ms")
        if dur is None:
            continue
        if name in phases:
            groups.setdefault(name, []).append(dur)
            fmt = (s.get("attrs") or {}).get("format")
            if fmt:
                groups.setdefault(
                    f'{name}{{format="{fmt}"}}', []).append(dur)
        elif name.startswith("http "):
            requests.append(dur)
    out = {"phases": {n: _stats(d) for n, d in sorted(groups.items())},
           "requests": _stats(requests) if requests else {"count": 0}}
    base = [n for n in phases if n in groups]
    out["phase_p50_sum_ms"] = round(
        sum(out["phases"][n]["p50_ms"] for n in base), 3)
    out["phase_mean_sum_ms"] = round(
        sum(out["phases"][n]["mean_ms"] for n in base), 3)
    return out
