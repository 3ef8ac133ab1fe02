"""pass_ms: the mean span of one streamed pass (every chunk reduced onto
the accumulator once), between CUDA events that the benchmark records
around each call of the stream it hands to the step."""


def read(ctx):
    if not ctx.pass_ms:
        return None
    return sum(ctx.pass_ms) / len(ctx.pass_ms)
