"""launches_per_frame (device trace): kernels, memcpys and memsets of the
traced frames over their number."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.events or not ctx.trace_frames:
        return None
    return len(ctx.trace.events) / ctx.trace_frames
