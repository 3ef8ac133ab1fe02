"""idle_stream_pct: the share of the device's idle time in the second
traced window (between its first operation's start and its last one's end,
the gaps of the union of the operations over all streams, as
``trace.reduce`` counts them) that lies inside the program's ``pass``
spans (``gpubench/spans.py``), in percent: how much of the card's waiting
the host spends in the streamed passes. None where the window holds no
``pass`` span."""
from gpubench import spans


def read(ctx):
    w = getattr(ctx, "spans", None)
    if w is None or not w.named(spans.PASS):
        return None
    inside, total = spans.idle_inside(w, spans.PASS)
    return 100.0 * inside / total if total else None
