"""A traced stretch: ``torch.profiler`` over a steady part of the
window, reduced to the device's intervals on the host's monotonic clock.

Only the device's activity is recorded (no CPU operator events, whose
recording slows the host several-fold in a launch-bound loop). The
profiler stamps device events on the wall clock; they are put on
``time.monotonic`` by the two clocks' difference read at the start, so
the benchmark's own spans (kept in monotonic seconds, in this process or
the client's) line up with the kernels. Without a card (the CPU tests)
the CPU's operators are recorded instead."""

import time

import torch

from .roofline.groups import kernel_group

#: device operations listed in a breakdown, and idle gaps
TOP = 10


def warm_up():
    """Start and stop the profiler once: its first start in a process
    sets up the device tracing, which took 10–14 s on an H100 and holds
    the whole process up; a traced run pays it in set-up, not in its
    window."""
    cap = Capture()
    cap.start()
    cap.stop()


class Capture:
    """``start()`` … ``stop()``, then :meth:`trace` → a :class:`Trace`
    of the stretch. Reading the profiler's events takes seconds of the
    interpreter for a busy stretch, so a run does it after its window
    has closed, where it holds up nothing that is measured."""

    def start(self):
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU])
        self.prof.start()
        self.offset_ns = time.time_ns() - time.monotonic_ns()
        self.t0 = time.monotonic()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop()

    def trace(self):
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CPU:
                continue
            start = (e.start_ns() - self.offset_ns) * 1e-9
            ops.append((e.name(), start, e.duration_ns() * 1e-9))
        return Trace(self.t0, self.t1, ops)


class Trace:
    """The device operations of a stretch ``[t0, t1]`` (monotonic
    seconds): ``ops`` ``[(name, start, seconds)]``, clipped to the
    stretch."""

    def __init__(self, t0, t1, ops):
        self.t0, self.t1 = t0, t1
        self.ops = []
        for name, s, d in ops:
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                self.ops.append((name, a, b - a))
        self.ops.sort(key=lambda o: o[1])

    @property
    def window_s(self):
        return self.t1 - self.t0

    def busy(self):
        """``(busy seconds, [(gap start, gap seconds)])``: the union of
        the operations' intervals and the idle gaps between them."""
        busy, gaps, end = 0.0, [], self.t0
        for _, s, d in self.ops:
            if s > end:
                gaps.append((end, s - end))
                busy += d
                end = s + d
            elif s + d > end:
                busy += s + d - end
                end = s + d
        if self.t1 > end:
            gaps.append((end, self.t1 - end))
        return busy, gaps

    def kernels(self):
        """The stretch's kernels (its operations other than copies and
        fills)."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    def seconds_in(self, group):
        """Summed seconds of the operations of a kernel group."""
        return sum(d for n, _, d in self.ops if kernel_group(n) == group)

    def top_ops(self, n=TOP):
        by = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def breakdown(self, label_at, n=TOP):
        """The contract's ``breakdown``: the device operations that took
        most time, and the longest idle gaps named by what the host was
        doing (``label_at(monotonic seconds) → name``)."""
        _, gaps = self.busy()
        gaps = sorted(gaps, key=lambda g: -g[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in self.top_ops(n)],
                "idle_gaps": [[label_at(s + d / 2), d] for s, d in gaps]}
