"""place_recognition_ms_per_keyframe (span "place_recognition"): host time
in place recognition and loop closing (LoopCloser.on_keyframe, or the
server's pass over its queue of new keyframes) over the keyframes it took."""


def read(ctx):
    recs = [r for r in ctx.spans.records if r[0] == "place_recognition"]
    kfs = sum(1 if r[4] is None else r[4] for r in recs)
    return sum(r[2] - r[1] for r in recs) / 1e6 / kfs if kfs else None
