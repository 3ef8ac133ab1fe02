"""chunk_host_us: the host's microseconds a chunk call: the program's
``pass`` spans' time over the chunks they reduced (their ``chunks``), in
the second traced window (``gpubench/spans.py``). A pass is the loop over
its chunks: fetching each, feeding the host ones, K2's wrapper and launch,
and the generators between them."""
from gpubench import spans


def read(ctx):
    w = getattr(ctx, "spans", None)
    if w is None or not w.chunks():
        return None
    return w.total_ns(spans.PASS) / 1e3 / w.chunks()
