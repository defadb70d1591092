"""track_ms_per_frame (span "fused_step"): host time in the port's fused
extract-and-track step over the window's frames."""


def read(ctx):
    frames = ctx.spans.n("frame")
    return ctx.spans.total_ms("fused_step") / frames if frames else None
