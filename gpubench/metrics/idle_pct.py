"""idle_pct: the share of the traced window in which the card ran no
kernel, copy or set (the union of their intervals over all streams)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
