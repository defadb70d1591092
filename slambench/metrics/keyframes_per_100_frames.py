"""keyframes_per_100_frames (the port's stats counters): keyframes the
agents inserted in the window per 100 frames; a work count."""


def read(ctx):
    return 100.0 * ctx.work["keyframes"] / ctx.frames if ctx.frames else None
