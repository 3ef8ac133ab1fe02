"""k2_launch_us: the mean ``k2.launch`` span of the second traced window
(``gpubench/spans.py``), in microseconds: K2's wrapper from its checks to
the launch's error check."""
from gpubench import spans


def read(ctx):
    w = getattr(ctx, "spans", None)
    n = 0 if w is None else len(w.named(spans.LAUNCH))
    return w.total_ns(spans.LAUNCH) / 1e3 / n if n else None
