"""pose_opt_ms_per_frame (the port's span "step.pose_opt"): host time in
the fused step's two pose optimisations over the window's frames."""

from slambench.harness import program_spans


def read(ctx):
    return program_spans.ms_per_frame(ctx, "step.pose_opt")
