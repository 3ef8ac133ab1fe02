"""k1_launch_us: the mean ``k1.launch`` span of the second traced window
(``gpubench/spans.py``), in microseconds: K1's wrapper from its checks to
the launch's error check."""

LAUNCH = "k1.launch"


def read(ctx):
    w = getattr(ctx, "spans", None)
    n = 0 if w is None else len(w.named(LAUNCH))
    return w.total_ns(LAUNCH) / 1e3 / n if n else None
