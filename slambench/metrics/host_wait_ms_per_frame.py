"""host_wait_ms_per_frame (the port's "wait.*" spans): host time spent
waiting on the device (the pipelined loop's readback of the previous
frame, forced adoptions of the mapping chain, the place-recognition
scores' copy) over the window's frames."""

from slambench.harness import program_spans


def read(ctx):
    rec = program_spans.window(ctx)
    if rec is None:
        return None
    waits = {s.name for s in rec.spans if s.name.startswith("wait.")}
    return program_spans.ms_per_frame(ctx, *waits)
