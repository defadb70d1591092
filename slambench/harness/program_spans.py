"""The port's own spans and counters in a run of a cell, and the traced
frames' device events attributed to them.

The port records them itself (multi_orbslam3_tpu_torch/utils/timing.py,
``GLOBAL_TIMER``; off unless its reader switches it on): a span is a stage
of the frame loop with its parent span and the id of the frame it works
for, on the host clock (time.perf_counter_ns), and ``host_syncs`` counts
the host's synchronisations under the innermost span. ``Records`` holds
what it recorded over one stretch of a run: the window, or the traced
frames. ``Recorder`` switches the tracer on over such a stretch
(slambench/run.py: the window with spans only, the traced frames with host
syncs too; only in a `--trace 1` run). A metric reader finds them on its
context as ``ctx.program`` (the window) and ``ctx.program_traced`` (the
traced frames); where the context has none (a `--trace 0` run, or a port
without the tracer), every reader here returns None.

``launch_host_ns`` gives each traced device event the host time of the
runtime call that launched it, through kineto's correlation id, mapped
onto the host clock by the trace's marker offset. ``tables`` are device
idle time, launches and host syncs over the traced frames by innermost
program span."""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Optional

from slambench.harness.trace import _DEVICE_ACTIVITY, MARKER, union_intervals

OUTSIDE = "-"          # no program span open


def tracer():
    """The port's tracer, or None where the port has none that can be
    switched on."""
    try:
        from multi_orbslam3_tpu_torch.utils import timing
    except ImportError:
        return None
    t = getattr(timing, "GLOBAL_TIMER", None)
    return t if all(hasattr(t, a) for a in ("start", "stop", "spans", "counts")) else None


class Records:
    """One stretch of the tracer's records: spans (name, t0, t1, parent,
    frame; parent an index into the list, -1 at the root) and counts
    (index of the innermost span or -1, name, n)."""

    def __init__(self, spans, counts):
        self.spans = spans
        self.counts = counts
        self._t0 = [s.t0 for s in spans]          # spans open in this order

    @classmethod
    def take(cls, tracer) -> "Records":
        return cls(list(tracer.spans), list(tracer.counts))

    def n(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)

    def total_ms(self, name: str) -> float:
        return sum(s.t1 - s.t0 for s in self.spans if s.name == name) / 1e6

    def counter(self, name: str) -> int:
        return sum(n for _, c, n in self.counts if c == name)

    def innermost(self, t_ns: int) -> int:
        """The index of the innermost span open at host time t_ns, -1 where
        none is. Spans nest, so the innermost is the last one opened before
        t_ns or the first of its ancestors still open."""
        i = bisect.bisect_right(self._t0, t_ns) - 1
        while i >= 0 and self.spans[i].t1 is not None and self.spans[i].t1 <= t_ns:
            i = self.spans[i].parent
        return i

    def name_at(self, t_ns: int) -> str:
        i = self.innermost(t_ns)
        return self.spans[i].name if i >= 0 else OUTSIDE

    def pose_latencies_ms(self) -> list:
        """Per frame id with both: the start of its `frame` span to the end
        of its `finalize` span."""
        start = {s.frame: s.t0 for s in self.spans if s.name == "frame"}
        return [(s.t1 - start[s.frame]) / 1e6 for s in self.spans
                if s.name == "finalize" and s.frame in start]


class Recorder:
    """The port's tracer over named stretches of a run: ``with
    rec.stretch(name, syncs):`` records the block (host syncs too where
    `syncs`), then keeps its Records under ``rec.records[name]`` and the
    tracer's summary() under ``rec.summaries[name]``. With no tracer (None)
    it records nothing."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.records, self.summaries = {}, {}

    @contextlib.contextmanager
    def stretch(self, name: str, syncs: bool):
        if self.tracer is None:
            yield
            return
        self.tracer.start(syncs=syncs)
        try:
            yield
        finally:
            self.tracer.stop()
            self.records[name] = Records.take(self.tracer)
            self.summaries[name] = self.tracer.summary()


def window(ctx) -> Optional[Records]:
    """The window's records, where they have frames."""
    rec = getattr(ctx, "program", None)
    return rec if rec is not None and rec.n("frame") else None


def traced(ctx) -> Optional[Records]:
    """The traced frames' records, where they have frames."""
    rec = getattr(ctx, "program_traced", None)
    return rec if rec is not None and rec.n("frame") else None


def ms_per_frame(ctx, *names: str) -> Optional[float]:
    """The window's host time in the spans `names` over its frames."""
    rec = window(ctx)
    if rec is None:
        return None
    return sum(rec.total_ms(name) for name in names) / rec.n("frame")


def launch_host_ns(trace) -> Optional[list]:
    """[(device event name, device start ns, duration ns, host ns of the
    runtime call that launched it or None)] of the traced frames' device
    events (kernels, memcpys, memsets; not the marker), None where the
    trace has no correlation to read."""
    prof = getattr(trace, "_prof", None)
    offset = getattr(trace, "offset_ns", None)
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None or offset is None:
        return None
    import torch
    launched, device = {}, []
    for e in results.events():
        corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device events of trace._device_events
            kind = e.activity_type() if hasattr(e, "activity_type") else "kernel"
            if kind in _DEVICE_ACTIVITY and MARKER not in e.name():
                device.append((e.name(), e.start_ns(), e.duration_ns(), corr))
        elif corr:          # a CUDA API call (cudaLaunchKernel, ...): the only host events
            launched[corr] = e.start_ns() - offset
    if not launched:
        return None
    return [(name, start, dur, launched.get(corr)) for name, start, dur, corr in device]


def idle_pieces(trace) -> list:
    """[(host ns from, host ns to)] of the traced frames' device idle
    time: the gaps between device activity inside the trace's window, on
    the host clock by the marker offset."""
    if trace.offset_ns is None:
        return []
    off = trace.offset_ns
    edges = [trace.t0_ns + off]
    for lo, hi in union_intervals(trace.events):
        edges += [lo, hi]
    edges.append(trace.t1_ns + off)
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, trace.t0_ns + off), min(b, trace.t1_ns + off)
        if b > a:
            out.append((a - off, b - off))
    return out


def tables(trace, rec: Records) -> dict:
    """Over the traced frames, by innermost program span: device idle ms,
    device launches, host syncs; and the traced frames' number."""
    idle = collections.defaultdict(float)
    bounds = sorted({t for s in rec.spans for t in (s.t0, s.t1)})
    for a, b in idle_pieces(trace):
        cuts = bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)]
        pts = [a] + cuts + [b]
        for p, q in zip(pts, pts[1:]):
            idle[rec.name_at(p)] += (q - p) / 1e6
    launches = collections.Counter()
    for _, _, _, h in launch_host_ns(trace) or []:
        launches[rec.name_at(h) if h is not None else OUTSIDE] += 1
    syncs = collections.Counter()
    for i, name, n in rec.counts:
        if name == "host_syncs":
            syncs[rec.spans[i].name if i >= 0 else OUTSIDE] += n
    return {"frames": rec.n("frame"), "idle_ms": dict(idle), "launches": dict(launches),
            "host_syncs": dict(syncs)}
