"""extract_ms_per_frame (the port's span "step.extract"): host time in the
fused step's extraction (both pyramids, K1, the per-level selection,
orientation and BRIEF) over the window's frames."""

from slambench.harness import program_spans


def read(ctx):
    return program_spans.ms_per_frame(ctx, "step.extract")
