"""hybrid_pass_us: the mean ``hybrid.pass`` span of the second traced window
(``gpubench/spans.py``), in microseconds: the host's time to issue one pass
of the port's hybrid layout, its K1 and K2 launches included."""

PASS = "hybrid.pass"


def read(ctx):
    w = getattr(ctx, "spans", None)
    n = 0 if w is None else len(w.named(PASS))
    return w.total_ns(PASS) / 1e3 / n if n else None
