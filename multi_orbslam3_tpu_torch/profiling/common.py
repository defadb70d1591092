"""Timing, launch counts and device traces for the profilers.

The port's counterpart of timing a jitted call with ``block_until_ready``
and reading a ``jax.profiler`` trace:

- ``timeit(fn, n, device)``: wall ms per call between two synchronisations
  and, on the card, the CUDA-event ms of the same n calls;
- ``launches(fn, device)``: device kernels and copies one call issues, read
  from ``torch.profiler``'s CUDA activity (``device_profile`` adds the
  union of their intervals, the call's device busy time);
  ``graph_launches(fn, device)`` counts the same as the nodes of a CUDA
  graph that captures the call, where the call can be captured;
- ``trace_window(device, frames)``: a context manager that traces the block
  with ``torch.profiler`` (CUDA activity) and reports the window's wall
  time, the union of its kernel, memcpy and memset intervals, the busy
  share (that union over the wall time), the 10 device ops with the most
  time and the launches per frame.

On the H100, a process that has launched kernels for a minute or more
without the profiler loses a few device events from each later traced
region (5 after a minute, about 46 ten minutes into chip_smoke.py), so
small calls read few or no launches there: take per-call launch counts
from a fresh process (profile_stages run on its own), or from
``graph_launches``, which reads no events.

On the CPU there is no device activity to read: ``launches`` returns None
and ``trace_window`` reports the wall time alone, with no busy share.
Measurement only: nothing here changes what the SLAM package computes.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional

import torch

# kineto's activity types of device-side work; the CUDA runtime and driver
# calls (cudaLaunchKernel, ...) are host-side and not counted
_DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device: torch.device) -> str:
    """The device a result was measured on."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def timeit(fn: Callable, n: int, device: torch.device) -> dict:
    """One warm-up call, then n calls between two synchronisations:
    {"wall_ms": host ms a call, "device_ms": ms a call between CUDA events
    recorded before and after the n calls (None on the CPU)}."""
    fn()
    sync(device)
    cuda = device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if cuda:
        end.record()
    sync(device)
    wall = (time.perf_counter() - t0) / n * 1e3
    return {"wall_ms": wall,
            "device_ms": start.elapsed_time(end) / n if cuda else None}


def _device_events(prof) -> list:
    """(name, start ns, duration ns) of every kernel, memcpy and memset of a
    finished torch.profiler run, read from kineto's events directly (the
    profiler's per-op tables are not built)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else "kernel"
        if kind in _DEVICE_ACTIVITY:
            out.append((e.name(), e.start_ns(), e.duration_ns()))
    return out


def device_profile(fn: Callable, device: torch.device) -> dict:
    """One call of fn (after one untraced call) under torch.profiler's CUDA
    activity: {"launches": kernels, memcpys and memsets it issued,
    "device_busy_ms": the union of their intervals}; both None on the
    CPU."""
    if device.type != "cuda":
        return {"launches": None, "device_busy_ms": None}
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    events = _device_events(prof)
    return {"launches": len(events), "device_busy_ms": busy_union_ns(events) / 1e6}


def launches(fn: Callable, device: torch.device) -> Optional[int]:
    """Kernels, memcpys and memsets that one call of fn issues on the card;
    None on the CPU."""
    return device_profile(fn, device)["launches"]


# CUgraphNodeType: the node types that are device launches, and a child graph
_GRAPH_LAUNCH_NODES = (0, 1, 2)      # kernel, memcpy, memset
_GRAPH_CHILD_NODE = 4


def graph_launches(fn: Callable, device: torch.device) -> Optional[int]:
    """Kernels, memcpys and memsets that one call of fn issues on the card,
    counted as the nodes of a CUDA graph that captures the call (after one
    uncaptured call), through the driver's cuGraphGetNodes and
    cuGraphNodeGetType, a child graph's nodes counted within it. Unlike
    ``launches`` it cannot lose events late in a process; fn must be
    capturable (no read-back). None on the CPU."""
    if device.type != "cuda":
        return None
    import ctypes
    fn()
    sync(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    def count(g) -> int:
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(ctypes.c_void_p(g), None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(ctypes.c_void_p(g), nodes, ctypes.byref(n)), "cuGraphGetNodes")
        total = 0
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            if kind.value in _GRAPH_LAUNCH_NODES:
                total += 1
            elif kind.value == _GRAPH_CHILD_NODE:
                child = ctypes.c_void_p()
                check(cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node),
                                                       ctypes.byref(child)),
                      "cuGraphChildGraphNodeGetGraph")
                total += count(child.value)
        return total

    try:
        return count(graph.raw_cuda_graph())
    finally:
        graph.reset()


def busy_union_ns(events: list) -> int:
    """Length of the union of the [start, start + duration) intervals."""
    total, cur_lo, cur_hi = 0, None, None
    for _, lo, dur in sorted(events, key=lambda e: e[1]):
        hi = lo + dur
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo if cur_hi is not None else 0)


def summarize(events: list, wall_s: float, frames: int, top: int = 10) -> dict:
    """The trace window's numbers from its device events."""
    by_name = collections.defaultdict(lambda: [0, 0])
    for name, _, dur in events:
        by_name[name][0] += dur
        by_name[name][1] += 1
    busy_ns = busy_union_ns(events)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    n_kernels = sum(1 for e in events if not e[0].startswith(("Memcpy", "Memset")))
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_ns / 1e6,
        "busy_share": busy_ns / 1e9 / wall_s,
        "device_ops_ms": sum(d for _, _, d in events) / 1e6,
        "launches_per_frame": len(events) / frames,
        "kernels_per_frame": n_kernels / frames,
        "top_device_ops": [{"name": n[:120], "ms": v[0] / 1e6, "calls": v[1],
                            "share_of_wall": v[0] / 1e9 / wall_s}
                           for n, v in top_ops]}


@contextlib.contextmanager
def trace_window(device: torch.device, frames: int):
    """Trace the block (``frames`` frames of a loop) with torch.profiler's
    CUDA activity. Yields a dict that is filled when the block ends:
    ``frames``, ``wall_ms`` and ``ms_per_frame`` (host clock between
    synchronisations), and on the card ``device_busy_ms``, ``busy_share``,
    ``device_ops_ms`` (the sum of the ops' own times, overlaps counted
    twice), ``launches_per_frame``, ``kernels_per_frame`` and
    ``top_device_ops`` (the 10 device ops with the most time: name, ms,
    calls, share of the wall time)."""
    out = {"frames": frames}
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        yield out
        wall = time.perf_counter() - t0
        out.update(wall_ms=wall * 1e3, ms_per_frame=wall * 1e3 / frames)
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        sync(device)
        wall = time.perf_counter() - t0
    out.update(summarize(_device_events(prof), wall, frames),
               ms_per_frame=wall * 1e3 / frames)
