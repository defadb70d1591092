"""local_ba_ms_per_keyframe (the port's span "mapping.local_ba"): host time
in the mapping chain's windowed bundle adjustment over its calls in the
window, one a keyframe."""

from slambench.harness import program_spans


def read(ctx):
    rec = program_spans.window(ctx)
    n = rec.n("mapping.local_ba") if rec is not None else 0
    return rec.total_ms("mapping.local_ba") / n if n else None
