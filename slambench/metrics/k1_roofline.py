"""k1_roofline (device trace): the summed least time of the traced
frames' K1 launches (slambench/harness/roofline.py) over their summed
device time, in %. Where the profiler dropped some of the launches' events,
the device time is their mean times the launches made."""

from slambench.harness import roofline

KERNEL = "fast_score_nms_levels_kernel"
MAX_LEVELS = 16       # levels of one K1 launch


def read(ctx):
    if ctx.trace is None or not ctx.tcap.k1:
        return None
    dev_s, n_ev = ctx.trace.kernel_time_s(KERNEL)
    if n_ev == 0:
        return None
    bound = sum(roofline.k1_bound_ms(ctx.card, lv, thr) for lv, thr in ctx.tcap.k1)
    launches = sum(-(-len(lv) // MAX_LEVELS) for lv, _ in ctx.tcap.k1)
    return 100.0 * bound / 1e3 / (dev_s / n_ev * launches)
