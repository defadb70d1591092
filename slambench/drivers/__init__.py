"""How a cell drives the port: one file a system, ``drivers/<system>.py``,
found by the configuration file's ``system`` (slambench/harness/files.py).

A driver is a closed loop: the next frame is fed when the previous call
returns. The file defines ``Driver``, called as ``Driver(cfg, frames,
device, spans, capture)`` with the port's SystemConfig, what the traffic's
generator returned, the torch device, the run's Spans and its Capture. A
driver provides:

- ``install()``: wraps the port's layer entries with spans
  (``spans.wrap``) and with the captures that the comparison reads
  (``capture.offer(kind, make_item)``); the recorder restores them;
- ``warmup(n)``: n rounds before the window, so that every path the window
  uses runs once at the cell's shapes;
- ``round()``: one round of the closed loop; returns the frames processed,
  0 when none is left;
- ``work()``: a dict of the port's work counts (``frames``, ``keyframes``,
  ``frames_lost``, ...), read before and after the window;
- ``map_size()``: a dict of the map's size, read after the window;
- ``frames_left()``: the frames not yet fed;
- ``release()``: drops the port's systems, before the reference runs;
- ``tcap``: a ``TraceCapture``, the kernel calls of the traced frames that
  the rooflines read;
- ``checked``: the capture kind that a run must have offered at least once
  to be correct;
- ``compared``: the comparison kinds it feeds, each a file
  ``compare/<kind>.py``, run in this order.
"""

from __future__ import annotations

from slambench.harness import files


class TraceCapture:
    """K1 and K2 calls of the traced frames (for the rooflines)."""

    def __init__(self):
        self.on = False
        self.k1, self.k2proj, self.k2valid = [], [], []


def make_driver(config: dict, cfg, frames, device, spans, capture, where: tuple):
    """The driver of the configuration's system, from `drivers/<system>.py`
    under the cell's roots `where`."""
    return files.load("drivers", config["system"], where).Driver(cfg, frames, device, spans,
                                                                 capture)
