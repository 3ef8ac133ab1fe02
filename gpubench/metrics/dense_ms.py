"""dense_ms: device milliseconds per traced step of every kernel other than
K2 and the copies: the projections, the loss, the elementwise pieces and
Adam."""
from gpubench.trace import is_copy, is_k2


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.seconds(lambda n: not is_k2(n) and not is_copy(n))
    return 1e3 * s / t.steps if s > 0 else None
