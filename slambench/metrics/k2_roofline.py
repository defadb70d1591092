"""k2_roofline (device trace): the summed least time of the traced
frames' K2 launches of the projection and validity searches
(slambench/harness/roofline.py) over their summed device time, in %. Where
the profiler dropped some events, each search's device time is its mean
per launch times the launches made."""

from slambench.harness import roofline

KERNELS = {"projection": ("proj_grid_kernel", 1), "valid": ("valid_compact", 2)}


def read(ctx):
    if ctx.trace is None:
        return None
    bound_ms = dev_s = 0.0
    calls = {"projection": ctx.tcap.k2proj, "valid": ctx.tcap.k2valid}
    for kind, (name, per_call) in KERNELS.items():
        if not calls[kind]:
            continue
        s, n_ev = ctx.trace.kernel_time_s(name)
        if n_ev == 0:
            continue
        dev_s += s / n_ev * per_call * len(calls[kind])
        if kind == "projection":
            bound_ms += sum(roofline.projection_bound_ms(ctx.card, *args)
                            for args in calls[kind])
        else:
            bound_ms += sum(roofline.valid_bound_ms(ctx.card, v1, v2)
                            for v1, v2 in calls[kind])
    return 100.0 * bound_ms / 1e3 / dev_s if dev_s > 0 else None
