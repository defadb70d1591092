"""Host spans and counters recorded from outside the port.

``Spans.wrap(owner, attr, name)`` replaces a function or method of the port
with one that records a span around each call and restores the original
when the recorder closes (``with Spans() as sp:``), the way the port's own
profilers wrap its stages. A span is (name, start ns, end ns, depth, extra)
on the host clock (time.perf_counter_ns); spans nest, and ``depth`` is the
nesting level at the call. Nothing inside the port changes.

Inside ``with sp.aside():`` spans go to ``sp.aside_records`` instead: the
frames run under the profiler, after the window, name the trace's idle
gaps and stay out of the host-span metrics.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional


class Spans:
    def __init__(self):
        self.records = []           # (name, t0_ns, t1_ns, depth, extra)
        self.counts = collections.Counter()
        self.aside_records = []
        self._restore = []
        self._stack = []
        self.on = False             # spans are kept only while on

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        while self._restore:
            owner, attr, orig, had = self._restore.pop()
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)

    @contextlib.contextmanager
    def aside(self):
        kept = self.records, self.counts
        self.records, self.counts = self.aside_records, collections.Counter()
        try:
            yield
        finally:
            self.records, self.counts = kept

    def current(self) -> Optional[str]:
        """The innermost open span's name."""
        return self._stack[-1] if self._stack else None

    def span(self, name: str, extra=None):
        return _SpanCtx(self, name, extra)

    def wrap(self, owner, attr: str, name: str,
             extra: Optional[Callable] = None, after: Optional[Callable] = None) -> None:
        """Record a span `name` around every call of owner.attr (no span
        when name is None). extra(*args, **kw) -> a value kept with the
        span (evaluated before the call); after(result, *args, **kw) runs
        after it (captures)."""
        had = attr in vars(owner)
        orig = getattr(owner, attr)
        rec = self

        def wrapped(*args, **kw):
            if name is None:
                out = orig(*args, **kw)
            else:
                ex = extra(*args, **kw) if extra is not None else None
                with _SpanCtx(rec, name, ex):
                    out = orig(*args, **kw)
            if after is not None:
                after(out, *args, **kw)
            return out

        setattr(owner, attr, wrapped)
        self._restore.append((owner, attr, orig, had))

    def replace(self, owner, attr: str, make) -> None:
        """owner.attr = make(original) until the recorder closes (the
        benchmark's own tests break the timed path this way)."""
        had = attr in vars(owner)
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._restore.append((owner, attr, orig, had))

    def total_ms(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1, _, _ in self.records if n == name) / 1e6

    def durations_ms(self, name: str):
        return [(t1 - t0) / 1e6 for n, t0, t1, _, _ in self.records if n == name]

    def n(self, name: str) -> int:
        return sum(1 for r in self.records if r[0] == name)


class _SpanCtx:
    __slots__ = ("rec", "name", "extra", "t0")

    def __init__(self, rec: Spans, name: str, extra):
        self.rec, self.name, self.extra = rec, name, extra

    def __enter__(self):
        self.rec._stack.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rec._stack.pop()
        if self.rec.on:
            self.rec.records.append((self.name, self.t0, t1, len(self.rec._stack), self.extra))
            self.rec.counts[self.name] += 1
        return False
