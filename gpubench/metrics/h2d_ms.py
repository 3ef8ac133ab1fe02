"""h2d_ms: device milliseconds per traced step of host-to-device copies
(the chunks fed from page-locked host memory)."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.seconds(lambda n: n.startswith("Memcpy HtoD"))
    return 1e3 * s / t.steps if s > 0 else None
