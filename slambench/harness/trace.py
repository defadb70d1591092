"""The traced frames of a `--trace 1` run: a fixed number of frames under
torch.profiler's CUDA activity, run after the window closes, in the run's
own process.
A copy of the port's profiling/common.trace_window arithmetic (device
events read from kineto, the union of their intervals as busy time), plus
the longest idle gaps named by the host span they fall in.

The host and device clocks are tied by one marker kernel
(torch.cuda._sleep) launched right after a synchronisation at a known
host time."""

from __future__ import annotations

import collections
import re
import time

import torch

_DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def _device_events(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else "kernel"
        if kind in _DEVICE_ACTIVITY:
            out.append((e.name(), e.start_ns(), e.duration_ns()))
    return out


def union_intervals(events: list) -> list:
    """[(lo, hi)] merged intervals of (name, start, dur) events."""
    out = []
    for _, lo, dur in sorted(events, key=lambda e: e[1]):
        hi = lo + dur
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def clean_name(name: str, n: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_.:]", "_", name)[:n]


class TraceWindow:
    """with TraceWindow(spans) as tw: ...frames...; then tw.events (device
    events without the marker), tw.wall_s, tw.offset_ns (device clock minus
    host clock), tw.t0_ns / t1_ns (host clock)."""

    def __init__(self):
        self.events = []
        self.wall_s = None
        self.offset_ns = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1_ns = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        events = _device_events(self._prof)
        marks = [e for e in events if MARKER in e[0]]
        if marks:
            self.offset_ns = marks[0][1] - self._marker_host
        self.events = [e for e in events if MARKER not in e[0]]
        self.wall_s = (self.t1_ns - self.t0_ns) / 1e9
        return False

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in union_intervals(self.events)) / 1e9

    def top_ops(self, top: int = 10) -> list:
        by_name = collections.defaultdict(int)
        for name, _, dur in self.events:
            by_name[clean_name(name)] += dur
        return [[n, d / 1e9] for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, span_records, top: int = 10) -> list:
        """The longest gaps between device activity inside the window, each
        named by the innermost host span open when the gap began."""
        if self.offset_ns is None:
            return []
        iv = union_intervals(self.events)
        lo_dev = self.t0_ns + self.offset_ns
        hi_dev = self.t1_ns + self.offset_ns
        edges = [lo_dev] + [x for pair in iv for x in pair] + [hi_dev]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo_dev), min(b, hi_dev)
            if b > a:
                gaps.append((b - a, a - self.offset_ns))
        gaps.sort(reverse=True)
        out = []
        for dur, host_t in gaps[:top]:
            inner, depth = "harness", -1
            for name, t0, t1, d, _ in span_records:
                if t0 <= host_t < t1 and d > depth:
                    inner, depth = name, d
            out.append([inner, dur / 1e9])
        return out

    def kernel_time_s(self, substr: str):
        """(seconds, launches) of the device events whose name holds substr."""
        hits = [d for n, _, d in self.events if substr in n]
        return sum(hits) / 1e9, len(hits)
