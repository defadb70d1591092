"""mapping_ms_per_keyframe (span "mapping"): host time in the port's
per-keyframe mapping chain (local_mapping.map_keyframe) over its calls."""


def read(ctx):
    n = ctx.spans.n("mapping")
    return ctx.spans.total_ms("mapping") / n if n else None
