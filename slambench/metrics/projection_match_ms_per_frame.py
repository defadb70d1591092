"""projection_match_ms_per_frame (the port's span "step.match"): host time
in the fused step's two projection matches against the map (K2's grid
search) over the window's frames."""

from slambench.harness import program_spans


def read(ctx):
    return program_spans.ms_per_frame(ctx, "step.match")
