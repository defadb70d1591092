"""frames_per_s (host clock): every frame of every agent processed in the
window over the window's wall time, which ends in a synchronise."""


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.window_s > 0 else None
