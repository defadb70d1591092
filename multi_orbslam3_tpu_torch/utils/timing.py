"""Per-stage wall-time profiling.

Replaces the reference's #ifdef SAVE_TIMES stopwatch blocks
(src/Tracking.cc:1529-1534 etc., SURVEY.md §5 "Tracing / profiling") with
an always-on, machine-readable stage timer: accumulates per-stage counts
/ totals / percentiles and dumps one JSON object. Overhead is one
perf_counter pair per stage; block_until_ready is the caller's choice
(device work is async — time what you mean to time).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class StageTimer:
    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            xs_sorted = sorted(xs)
            n = len(xs_sorted)
            out[name] = {
                "count": n,
                "total_s": round(sum(xs), 4),
                "mean_ms": round(1e3 * sum(xs) / n, 3),
                "p50_ms": round(1e3 * xs_sorted[n // 2], 3),
                "p95_ms": round(1e3 * xs_sorted[min(n - 1, int(0.95 * n))], 3),
            }
        return out

    def dump(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)


GLOBAL_TIMER = StageTimer()


def timed(name: str):
    """Decorator routing a function through the global stage timer."""
    def wrap(fn):
        def inner(*a, **kw):
            with GLOBAL_TIMER.stage(name):
                return fn(*a, **kw)
        return inner
    return wrap
