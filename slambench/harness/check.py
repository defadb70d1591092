"""The comparison that decides `correct`: the plain reference
(slambench/reference) works out again, from the inputs the benchmark handed
the port and the map the port held, what each sampled call of the window
produced, and each compared number is held to its limit in
slambench/checks/<cell>.json.

The reference follows the port step by step from the port's own state: a
tracked frame is recomputed from the frame's images and the map that frame
was tracked against; a place-recognition query from the query keyframe's
descriptors and every database keyframe's descriptors in the map; a K2
search from its inputs. Each kind of call has its comparison file,
``compare/<kind>.py`` (slambench/compare/__init__.py gives its contract),
which names its numbers; the driver's ``compared`` lists the kinds a cell
runs.
"""

from __future__ import annotations

import math

import torch

from slambench.harness import files
from slambench.reference import float32_precision


class Tally:
    def __init__(self):
        self.num, self.den, self.max = {}, {}, {}

    def frac(self, name: str, bad, total) -> None:
        self.num[name] = self.num.get(name, 0) + int(bad)
        self.den[name] = self.den.get(name, 0) + int(total)

    def worst(self, name: str, value: float) -> None:
        self.max[name] = max(self.max.get(name, 0.0), float(value))

    def numbers(self) -> dict:
        out = {k: self.num[k] / max(self.den[k], 1) for k in self.num}
        out.update(self.max)
        return out


def run_checks(capture, cfg, device, compared, where: tuple, control: bool = False) -> dict:
    """Every compared number of the captured calls against the reference
    in float32, kind by kind of `compared` (files under the cell's roots
    `where`); with control=True, of the control's outputs instead."""
    tally = Tally()
    for kind in compared:
        cmp = files.load("compare", kind, where)
        items = [it for prefix in getattr(cmp, "CAPTURES", (kind,))
                 for it in capture.items(prefix)]
        if control:
            with torch.no_grad(), float32_precision(tf32=True):
                items = cmp.control(items, cfg, device)
        with torch.no_grad(), float32_precision(False):
            cmp.check(items, cfg, device, tally)
    return tally.numbers()


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number of the cell's check
    file finite and within its limit. A number marked "every_run" must be
    there; the others (place recognition) only where the window made such
    a call."""
    rows, ok = [], True
    for name, spec in limits.items():
        v = numbers.get(name)
        lim = float(spec["limit"])
        good = (v is None and not spec.get("every_run", True)) or (
            v is not None and math.isfinite(v) and v <= lim)
        ok &= good
        rows.append((name, v, lim))
    return ok, rows
