"""Prometheus-style metrics, dependency-free — the port's own copy of
``kubeflow_tpu/obs/metrics.py`` (copied, never imported: the port
stands alone). Its ``REGISTRY`` is the port's process-global registry,
separate from the JAX package's.

Counter/Gauge/Histogram with label values and a text-format exposition.
Grew out of the notebook-controller metric registry (reference
components/notebook-controller/pkg/metrics/metrics.go:27-56); promoted
here so every layer (core controllers, web apps, the model server)
shares ONE process-global registry and one ``/metrics`` surface, the
way controller-runtime binds every controller's families to a single
prometheus.Registry behind one metrics endpoint.

Histogram follows Prometheus bucket semantics exactly: cumulative
``<name>_bucket{le="..."}`` series ending at ``le="+Inf"``, plus
``<name>_sum`` and ``<name>_count`` — what a real Prometheus scrape of
controller-runtime's ``*_seconds`` families looks like.

Metric names are validated at registration (``^[a-z_][a-z0-9_]*$``,
non-empty help) so the CI lint (ci/metrics_lint.py) can never find a
family that was registered but unscrapeable.

Histogram observations may carry an OpenMetrics **exemplar**
(``observe(value, trace_id=...)``): the bucket line the value lands in
gains a ``# {trace_id="..."} <value> <ts>`` suffix, so a p99 bucket on
a latency chart links straight to its trace in ``/debug/traces``. The
serving/web middleware only attaches trace ids of KEPT traces (see
obs/tracing.py sampling), and ci/metrics_lint.py validates the suffix
syntax so the exposition stays parseable.
"""

import os
import re
import threading
import time

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-zA-Z0-9_]*$")

#: Prometheus client default buckets — right-sized for request latency
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

#: exposition Content-Type (Prometheus text format 0.0.4)
TEXT_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def env_float(name, default):
    """Float env knob with a safe fallback — shared by the obs layer's
    runtime-tunable settings (tracing sample rates, SLO windows,
    exemplar gating)."""
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def exemplars_enabled():
    """``OBS_EXEMPLARS`` (default on): emit OpenMetrics exemplar
    suffixes on histogram bucket lines. Exemplars use OpenMetrics
    syntax while the exposition Content-Type stays text 0.0.4 — this
    platform's own scrapers (the metrics hub, ci/metrics_lint.py,
    obs/aggregate.py) all parse them, but a STRICT external Prometheus
    pointed directly at a pod's ``/metrics`` would reject the page;
    such deployments set ``OBS_EXEMPLARS=0`` (read per exposition, so
    it can be flipped live). The trace ids are still collected either
    way — only the text suffix is gated."""
    return os.environ.get("OBS_EXEMPLARS", "1").lower() not in (
        "0", "false", "no", "off")


def _escape_label_value(value):
    """Prometheus text-format 0.0.4 label-value escaping: backslash,
    double-quote, and newline. Label VALUES are arbitrary user text
    (e.g. spec.queue flows into the sched_* families) — one unescaped
    quote or embedded newline would corrupt the whole exposition for
    every family in the process."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(names, values, extra=()):
    pairs = [f'{n}="{_escape_label_value(v)}"'
             for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label_value(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(value):
    """Exposition value formatting: integral values stay terse (``1``),
    everything else keeps full float precision via the shortest
    round-trip repr — ``%g``'s 6 significant digits would corrupt
    unix-timestamp gauges (process_start_time_seconds) and large
    counters by thousands."""
    if value != value:
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 2 ** 53:
        return str(int(value))
    return repr(value)


class _Metric:
    def __init__(self, name, help_text, label_names):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._values = {}
        self._lock = threading.Lock()

    def labels(self, *values):
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {values}")
        return self._child_cls(self, tuple(str(v) for v in values))

    def value(self, *values):
        return self._values.get(tuple(str(v) for v in values), 0.0)

    def samples(self):
        with self._lock:
            return dict(self._values)

    def expose(self, lines):
        samples = self.samples()
        if not samples and not self.label_names:
            lines.append(f"{self.name} 0")
        for key, value in sorted(samples.items()):
            lines.append(f"{self.name}"
                         f"{_fmt_labels(self.label_names, key)} "
                         f"{_fmt_value(value)}")


class _Child:
    def __init__(self, metric, key):
        self._m = metric
        self._key = key

    def inc(self, amount=1.0):
        with self._m._lock:
            self._m._values[self._key] = \
                self._m._values.get(self._key, 0.0) + amount

    def set(self, value):
        with self._m._lock:
            self._m._values[self._key] = float(value)


_Metric._child_cls = _Child


class Counter(_Metric):
    type_name = "counter"

    def inc(self, amount=1.0):
        self.labels().inc(amount)


class Gauge(_Metric):
    type_name = "gauge"

    def set(self, value):
        self.labels().set(value)


def _fmt_exemplar(ex):
    """OpenMetrics exemplar suffix: ``# {labels} value timestamp``."""
    trace_id, value, ts = ex
    return (f' # {{trace_id="{_escape_label_value(trace_id)}"}} '
            f"{_fmt_value(value)} {_fmt_value(round(ts, 3))}")


class _HistogramChild:
    def __init__(self, metric, key):
        self._m = metric
        self._key = key

    def observe(self, value, trace_id=None):
        value = float(value)
        m = self._m
        with m._lock:
            state = m._values.get(self._key)
            if state is None:
                state = m._values[self._key] = \
                    {"buckets": [0] * len(m.buckets), "sum": 0.0,
                     "count": 0}
            first = None
            for i, le in enumerate(m.buckets):
                if value <= le:
                    if first is None:
                        first = i
                    state["buckets"][i] += 1
            state["sum"] += value
            state["count"] += 1
            if trace_id:
                # latest exemplar per bucket the value belongs to
                # (+Inf = index len(buckets)); exposition appends it
                # to that bucket's line
                state.setdefault("exemplars", {})[
                    len(m.buckets) if first is None else first] = (
                    str(trace_id), value, time.time())


class Histogram(_Metric):
    """Prometheus histogram: cumulative buckets + sum + count.

    ``buckets`` are upper bounds; ``+Inf`` is implicit (it IS the
    count). Observations are O(len(buckets)) under the metric lock —
    fine for the ≤20-bucket families this platform registers.
    """

    type_name = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help_text, label_names,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.buckets = bounds

    def observe(self, value, trace_id=None):
        self.labels().observe(value, trace_id=trace_id)

    def samples(self):
        # deep-copy per-key state: observe() mutates the inner dicts in
        # place, and a scrape reading them outside the lock could see a
        # torn (non-cumulative) histogram
        with self._lock:
            return {k: {"buckets": list(v["buckets"]), "sum": v["sum"],
                        "count": v["count"],
                        **({"exemplars": dict(v["exemplars"])}
                           if "exemplars" in v else {})}
                    for k, v in self._values.items()}

    def value(self, *values):
        """Observation count for the label set (0 if never observed)."""
        state = self._values.get(tuple(str(v) for v in values))
        return 0 if state is None else state["count"]

    def expose(self, lines):
        samples = self.samples()
        if not samples and not self.label_names:
            # an unobserved label-less histogram still exposes its
            # (empty) buckets, like prometheus/client_python
            samples = {(): {"buckets": [0] * len(self.buckets),
                            "sum": 0.0, "count": 0}}
        emit_ex = exemplars_enabled()
        for key, state in sorted(samples.items()):
            exemplars = (state.get("exemplars") or {}) if emit_ex \
                else {}
            for i, (le, n) in enumerate(zip(self.buckets,
                                            state["buckets"])):
                ex = exemplars.get(i)
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(self.label_names, key, [('le', f'{le:g}')])}"
                    f" {n}{_fmt_exemplar(ex) if ex else ''}")
            ex = exemplars.get(len(self.buckets))
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.label_names, key, [('le', '+Inf')])}"
                f" {state['count']}{_fmt_exemplar(ex) if ex else ''}")
            labels = _fmt_labels(self.label_names, key)
            lines.append(f"{self.name}_sum{labels} "
                         f"{_fmt_value(state['sum'])}")
            lines.append(f"{self.name}_count{labels} {state['count']}")


class Registry:
    def __init__(self):
        self._metrics = []
        self._by_name = {}
        self._collect_hooks = []
        self._lock = threading.Lock()

    def _register(self, cls, name, help_text, label_names, **kwargs):
        if not _NAME_RE.match(name or ""):
            raise ValueError(
                f"metric name {name!r} must match {_NAME_RE.pattern}")
        if not (help_text or "").strip():
            raise ValueError(f"metric {name} needs non-empty help text")
        for ln in label_names:
            if not _LABEL_RE.match(ln or ""):
                raise ValueError(
                    f"{name}: label name {ln!r} must match "
                    f"{_LABEL_RE.pattern}")
        with self._lock:
            existing = self._by_name.get(name)
            if existing is not None:
                # idempotent re-registration (same shape) returns the
                # live family — module-level families stay singletons
                # even if an entrypoint imports twice
                same_shape = (type(existing) is cls
                              and existing.label_names
                              == tuple(label_names))
                if same_shape and cls is Histogram:
                    same_shape = existing.buckets == tuple(
                        sorted(float(b)
                               for b in kwargs.get("buckets",
                                                   DEFAULT_BUCKETS)))
                if same_shape:
                    return existing
                raise ValueError(
                    f"metric {name} already registered as "
                    f"{type(existing).__name__}{existing.label_names}")
            metric = cls(name, help_text, label_names, **kwargs)
            self._metrics.append(metric)
            self._by_name[name] = metric
            return metric

    def counter(self, name, help_text, label_names=()):
        return self._register(Counter, name, help_text, label_names)

    def gauge(self, name, help_text, label_names=()):
        return self._register(Gauge, name, help_text, label_names)

    def histogram(self, name, help_text, label_names=(),
                  buckets=DEFAULT_BUCKETS):
        return self._register(Histogram, name, help_text, label_names,
                              buckets=buckets)

    def add_collect_hook(self, fn):
        """fn() runs before exposition — used for scrape-time gauges like
        notebook_running (reference metrics.go:74-99)."""
        self._collect_hooks.append(fn)

    def lint(self):
        """Return a list of problems (CI gate; registration already
        validates, so this also covers registries assembled by hand)."""
        problems = []
        for metric in self._metrics:
            if not _NAME_RE.match(metric.name or ""):
                problems.append(
                    f"{metric.name!r}: name must match {_NAME_RE.pattern}")
            if not (metric.help or "").strip():
                problems.append(f"{metric.name}: missing help text")
            for ln in metric.label_names:
                if not _LABEL_RE.match(ln or ""):
                    problems.append(f"{metric.name}: bad label {ln!r}")
        return problems

    def exposition(self):
        for fn in self._collect_hooks:
            fn()
        lines = []
        for metric in self._metrics:
            lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.type_name}")
            metric.expose(lines)
        return "\n".join(lines) + "\n"


#: the process-global default registry every layer registers into;
#: ``/metrics`` on any web App or the ModelServer serves THIS
REGISTRY = Registry()


def default_registry():
    return REGISTRY
