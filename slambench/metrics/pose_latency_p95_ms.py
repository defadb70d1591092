"""pose_latency_p95_ms (the port's spans "frame" and "finalize"): per frame
of the window, the start of the call that receives it to the end of the
host's decision on its pose (in the pipelined loop, inside the call that
receives the next frame); the 95th percentile, over 20 frames or more."""

import numpy as np

from slambench.harness import program_spans


def read(ctx):
    rec = program_spans.window(ctx)
    d = rec.pose_latencies_ms() if rec is not None else []
    return float(np.percentile(d, 95)) if len(d) >= 20 else None
