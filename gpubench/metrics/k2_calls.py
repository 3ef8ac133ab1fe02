"""k2_calls: K2's launches a step: the ``launches`` of the ``pass`` spans
inside the second traced window's ``step`` spans (``gpubench/spans.py``),
over the number of those steps."""
from gpubench import spans


def read(ctx):
    w = getattr(ctx, "spans", None)
    if w is None:
        return None
    steps = {s[4] for s in w.named(spans.STEP)}
    if not steps:
        return None
    return sum(s[5]["launches"] for s in w.named(spans.PASS) if s[4] in steps) / len(steps)
