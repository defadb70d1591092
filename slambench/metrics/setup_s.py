"""setup_s (host clock): process start to the first timed frame: imports,
the kernels' build or load, the systems and vocabulary, the frames
rendered on the card, the warm-up."""


def read(ctx):
    return ctx.setup_s
