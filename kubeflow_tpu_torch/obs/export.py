"""Cross-process metric/span export — the port's own copy of
``kubeflow_tpu/obs/export.py``, the worker side of the fleet telemetry
plane.

The registry and span ring are in-process; this module makes a process
periodically snapshot them to the shared workspace, in the JAX
package's shard format so one metrics hub merges both:

- ``$WORKSPACE/obs/shards/<pod>.prom`` — the process registry in
  Prometheus text format 0.0.4, preceded by one magic comment line
  carrying the pod name, the process epoch (restart detection) and the
  snapshot time (gauge staleness eviction):

      # kubeflow-tpu-shard pod="w0" epoch=1722700000.123 ts=1722700065.5

- ``<pod>.spans.json`` — the completed spans of the process ring
  buffer, for trace stitching.

Writes are atomic (temp file + ``os.replace`` in the same directory),
so a reader never observes a torn shard. The exporter is a daemon
thread; ``stop()`` does a final flush.

Resolution is env-driven so every entry point can call
``start_exporter()`` unconditionally: no export directory resolvable →
no exporter, zero overhead.
"""

import json
import os
import re
import socket
import tempfile
import threading
import time

from . import metrics as obs_metrics
from . import tracing

#: magic first line of a metric shard (aggregate.py keys on it)
SHARD_MAGIC = "# kubeflow-tpu-shard"

_HEADER_RE = re.compile(
    r'^# kubeflow-tpu-shard pod="((?:[^"\\]|\\.)*)" '
    r'epoch=([0-9.]+) ts=([0-9.]+)$')

_POD_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]")

#: default shard interval — fast enough that a 15s Prometheus scrape
#: of the hub sees near-live worker state, slow enough to be noise on
#: a training loop
DEFAULT_INTERVAL = 5.0

#: the standard Prometheus process-start family, anchored at the
#: runtime's spawn stamp (OBS_SPAWNED_AT) when present so it covers
#: interpreter + import time — ``shard ts - process_start`` is the
#: pod's true wall-clock (the goodput acceptance check keys on it)
PROCESS_START = obs_metrics.REGISTRY.gauge(
    "process_start_time_seconds",
    "Unix time this process was spawned (OBS_SPAWNED_AT anchor, else "
    "exporter start)")


def process_start_time():
    spawned = os.environ.get("OBS_SPAWNED_AT")
    try:
        return float(spawned) if spawned else None
    except ValueError:
        return None


def resolve_dir(directory=None):
    """Resolve the shard directory: explicit arg > ``OBS_EXPORT_DIR``
    env (empty string opts out) > ``$WORKSPACE/obs/shards`` >
    ``/workspace/obs/shards`` when the workspace PVC is mounted > None
    (export disabled)."""
    if directory:
        return directory
    env = os.environ.get("OBS_EXPORT_DIR")
    if env is not None:
        return env or None
    workspace = os.environ.get("WORKSPACE")
    if workspace:
        return os.path.join(workspace, "obs", "shards")
    if os.path.isdir("/workspace"):
        return "/workspace/obs/shards"
    return None


def pod_name(name=None, fallback=None):
    """The shard identity: explicit ``name`` > ``OBS_POD_NAME`` >
    ``POD_NAME`` (downward API) > ``fallback`` > hostname-pid (unique
    per process on a shared host).

    Components pass their component name as ``fallback``, NOT ``name``:
    in a cluster the downward-API POD_NAME must win, or two replicas of
    one component would overwrite each other's shard — and the
    aggregator would read every alternation as a restart, folding the
    counter base without bound."""
    name = (name or os.environ.get("OBS_POD_NAME")
            or os.environ.get("POD_NAME") or fallback
            or f"{socket.gethostname()}-{os.getpid()}")
    return _POD_SAFE_RE.sub("_", str(name))


def format_header(pod, epoch, ts):
    escaped = pod.replace("\\", "\\\\").replace('"', '\\"')
    return f'{SHARD_MAGIC} pod="{escaped}" epoch={epoch:.3f} ts={ts:.3f}'


def parse_header(line):
    """Header line → (pod, epoch, ts) or None."""
    mo = _HEADER_RE.match(line.strip())
    if mo is None:
        return None
    pod = re.sub(r'\\(["\\])', lambda m: m.group(1), mo.group(1))
    return pod, float(mo.group(2)), float(mo.group(3))


def _atomic_write(path, data):
    directory = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ShardExporter:
    """Periodic snapshots of one process's registry + span ring."""

    def __init__(self, directory, pod=None, registry=None, traces=None,
                 interval=DEFAULT_INTERVAL):
        self.directory = directory
        self.pod = pod_name(pod)
        self.registry = registry or obs_metrics.REGISTRY
        self.traces = traces if traces is not None else tracing.TRACES
        self.interval = float(interval)
        #: process epoch: a restarted pod re-exports under the same pod
        #: name with a NEW epoch — the aggregator's counter-reset signal
        self.epoch = time.time()
        if self.registry is obs_metrics.REGISTRY:
            PROCESS_START.set(process_start_time() or self.epoch)
        self._stop = threading.Event()
        self._thread = None

    @property
    def metrics_path(self):
        return os.path.join(self.directory, f"{self.pod}.prom")

    @property
    def spans_path(self):
        return os.path.join(self.directory, f"{self.pod}.spans.json")

    def write_once(self):
        """One atomic snapshot of metrics + spans. Raises on I/O
        failure (start()'s loop swallows and retries; a caller doing a
        final explicit flush wants the error)."""
        os.makedirs(self.directory, exist_ok=True)
        now = time.time()
        _atomic_write(self.metrics_path,
                      format_header(self.pod, self.epoch, now) + "\n"
                      + self.registry.exposition())
        if self.traces is not None:
            spans = [s.to_dict() for s in self.traces.spans()]
            _atomic_write(self.spans_path, json.dumps(
                {"pod": self.pod, "epoch": self.epoch, "ts": now,
                 "spans": spans}))

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"obs-shard-exporter-{self.pod}")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.write_once()
            except OSError:
                # a full / briefly-unavailable workspace must not kill
                # the exporter; the next tick retries
                pass

    def stop(self, flush=True):
        """Stop the thread; final flush so a finishing worker's last
        observations (final step, goodput tail) reach the fleet."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
            self._thread = None
        if flush:
            try:
                self.write_once()
            except OSError:
                pass


def start_exporter(directory=None, pod=None, interval=None,
                   fallback_pod=None, **kwargs):
    """Start a ShardExporter if an export directory resolves, else
    None. The one-liner every worker entrypoint calls unconditionally:

        exporter = export.start_exporter()
        ...
        if exporter: exporter.stop()

    ``fallback_pod`` names the shard only when no env identity
    resolves (see pod_name) — what the cmd entrypoints pass.
    """
    directory = resolve_dir(directory)
    if directory is None:
        return None
    if interval is None:
        interval = float(os.environ.get("OBS_EXPORT_INTERVAL",
                                        DEFAULT_INTERVAL))
    return ShardExporter(directory,
                         pod=pod or pod_name(fallback=fallback_pod),
                         interval=interval, **kwargs).start()
