"""frame_latency_p95_ms (span "frame"): the 95th percentile of the host
time of every frame of the window; the sample count is the work line's
frames."""

import numpy as np


def read(ctx):
    d = ctx.spans.durations_ms("frame")
    return float(np.percentile(d, 95)) if len(d) >= 20 else None
