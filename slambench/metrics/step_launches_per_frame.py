"""step_launches_per_frame (device trace): kernels, memcpys and memsets of
the traced frames launched inside the fused step, over the traced frames'
number. A device event belongs to the step when the runtime call that
launched it (kineto's correlation id; the host clock by the trace's marker
offset) falls inside a span "fused_step" of the traced frames, the call of
tracking.fused_step_stereo_chained."""

import bisect

from slambench.harness import program_spans


def read(ctx):
    if ctx.trace is None or not ctx.trace_frames:
        return None
    launched = program_spans.launch_host_ns(ctx.trace)
    steps = sorted((t0, t1) for name, t0, t1, _, _ in ctx.spans.aside_records
                   if name == "fused_step")
    if not launched or not steps:
        return None
    starts = [t0 for t0, _ in steps]
    n = 0
    for _, _, _, h in launched:
        i = bisect.bisect_right(starts, h) - 1 if h is not None else -1
        n += i >= 0 and h < steps[i][1]
    return n / ctx.trace_frames
