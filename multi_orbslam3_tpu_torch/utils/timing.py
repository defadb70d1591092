"""The port's tracer: host spans and counters of the frame loop.

A span is one stage of the work, opened where the work is done::

    with GLOBAL_TIMER.stage("step"):
        ...

It records its name, its start and end on ``time.perf_counter_ns()``, the
span it runs inside (``parent``, an index into ``spans``; -1 at the root)
and the id of the frame it works for (``frame``; a span given none takes
its parent's, -1 at the root). ``count(name, n)`` files a count under the
innermost open span. The records stay in memory, and the code that
switched the tracer on reads them when its run ends: ``spans`` and
``counts`` themselves, or ``summary()`` / ``dump()``.

The tracer is off unless its reader switches it on (``with
GLOBAL_TIMER.recording(): ...``, or ``start()`` / ``stop()``); nothing
reads an environment variable or a configuration key. Off, ``stage`` is
one attribute check that returns a shared no-op context: no clock read, no
allocation. On or off it never synchronises the device, reads nothing back
from it and calls neither ``torch.profiler.record_function`` nor NVTX.

``recording(syncs=True)`` (the default) also counts the host's
synchronisations with the device, as the counter ``host_syncs``: on a CUDA
machine it sets ``torch.cuda.set_sync_debug_mode("warn")`` and counts each
warning that mode raises, under the innermost span, instead of showing it.
The mode flags PyTorch's synchronising calls (``.item()``, ``.cpu()`` of a
device tensor, ``nonzero``, ``torch.cuda.synchronize()``); an explicit
``Event.synchronize`` is not among them, and the port times each of its
own as a ``wait.*`` span. The mode and the warning filters are put back
when recording stops, however the block ends.
"""

from __future__ import annotations

import contextlib
import json
import time
import warnings
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

SYNC_WARNING = "called a synchronizing CUDA operation"


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Span:
    """One span's record; the context that opens and closes it."""

    __slots__ = ("name", "t0", "t1", "parent", "frame", "_tracer")

    def __init__(self, tracer: "StageTimer", name: str, frame):
        self._tracer, self.name, self.frame = tracer, name, frame
        self.t0 = self.t1 = None
        self.parent = -1

    def __enter__(self):
        tr = self._tracer
        if tr._stack:
            self.parent = tr._stack[-1]
        if self.frame is None:
            self.frame = tr.spans[self.parent].frame if self.parent >= 0 else -1
        tr._stack.append(len(tr.spans))
        tr.spans.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        self._tracer._stack.pop()
        return False


def _row(xs_s: List[float]) -> Dict[str, float]:
    xs_sorted = sorted(xs_s)
    n = len(xs_sorted)
    return {
        "count": n,
        "total_s": round(sum(xs_s), 4),
        "mean_ms": round(1e3 * sum(xs_s) / n, 3),
        "p50_ms": round(1e3 * xs_sorted[n // 2], 3),
        "p95_ms": round(1e3 * xs_sorted[min(n - 1, int(0.95 * n))], 3),
    }


class StageTimer:
    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        # (index of the innermost open span or -1, counter name, n)
        self.counts: List[Tuple[int, str, int]] = []
        self._stack: List[int] = []
        self._restore = None

    def stage(self, name: str, frame=None):
        """A span `name` for the `with` block; `frame` the id of the frame
        it works for (None: its parent's)."""
        if not self.on:
            return _NO_SPAN
        return Span(self, name, frame)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        self.counts.append((self._stack[-1] if self._stack else -1, name, n))

    # ------------------------------------------------------------------
    def start(self, syncs: bool = True) -> None:
        """Switch on with empty records (see the module docstring)."""
        if self.on:
            raise RuntimeError("the tracer is already recording")
        if self._stack:
            raise RuntimeError("spans of an earlier recording are still open")
        self.spans, self.counts = [], []
        if syncs:
            self._restore = self._count_syncs()
        self.on = True

    def stop(self) -> None:
        """Switch off; the records stay until the next start."""
        self.on = False
        restore, self._restore = self._restore, None
        if restore is not None:
            restore()

    @contextlib.contextmanager
    def recording(self, syncs: bool = True) -> Iterator["StageTimer"]:
        self.start(syncs)
        try:
            yield self
        finally:
            self.stop()

    def _count_syncs(self):
        """Route the sync debug mode's warnings into `host_syncs`; returns
        what puts the warning state and the mode back."""
        import torch
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                self.count("host_syncs")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
            torch.cuda.set_sync_debug_mode("warn")

        def restore():
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)
        return restore

    # ------------------------------------------------------------------
    def self_ns(self) -> List[int]:
        """Each closed span's duration less the part its children cover
        (0 for a span still open)."""
        cover = [0] * len(self.spans)
        for s in self.spans:
            if s.parent >= 0 and s.t1 is not None:
                cover[s.parent] += s.t1 - s.t0
        return [s.t1 - s.t0 - c if s.t1 is not None else 0
                for s, c in zip(self.spans, cover)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: count, total_s, mean_ms, p50_ms, p95_ms; per name
        whose spans have children, "<name>:self" the same of their self
        times; per counter, "<span name>:<counter>" (the bare counter's name
        outside any span) {"count": its sum}."""
        times, selfs, parents = defaultdict(list), defaultdict(list), set()
        for s, self_t in zip(self.spans, self.self_ns()):
            if s.t1 is None:
                continue
            times[s.name].append((s.t1 - s.t0) / 1e9)
            selfs[s.name].append(self_t / 1e9)
            if s.parent >= 0:
                parents.add(self.spans[s.parent].name)
        out = {name: _row(xs) for name, xs in times.items()}
        out.update({f"{name}:self": _row(selfs[name]) for name in parents})
        counted = defaultdict(int)
        for i, name, n in self.counts:
            counted[f"{self.spans[i].name}:{name}" if i >= 0 else name] += n
        out.update({key: {"count": n} for key, n in counted.items()})
        return out

    def dump(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)


# the program's one tracer
GLOBAL_TIMER = StageTimer()
