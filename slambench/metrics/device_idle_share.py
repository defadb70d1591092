"""device_idle_share (device trace): the share of the traced frames' wall
time in which no kernel, memcpy or memset ran on the card, in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall_s)
