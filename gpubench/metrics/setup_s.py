"""setup_s: seconds from the start of the process to the first timed step:
imports, the kernels' build on a checkout's first run, inputs, weights and
chunks made on the card, and the check steps that warm every shape."""


def read(ctx):
    if ctx.trace is not None:
        return None
    return ctx.setup_s
