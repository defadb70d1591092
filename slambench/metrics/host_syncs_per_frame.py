"""host_syncs_per_frame (the port's counter "host_syncs"): the host's
synchronisations with the device that PyTorch's sync debug mode flags,
counted by the port's tracer over the traced frames, over their number."""

from slambench.harness import program_spans


def read(ctx):
    rec = program_spans.traced(ctx)
    return rec.counter("host_syncs") / rec.n("frame") if rec is not None else None
