"""feed_host_us: the host's microseconds a chunk copied in from the host:
the ``chunk.feed`` spans (queueing the copies and their event) and the
``chunk.sync`` spans (the compute stream's wait and ``record_stream``) of
the second traced window (``gpubench/spans.py``), over the ``pass`` spans'
``copies``. None where no chunk was copied."""
from gpubench import spans


def read(ctx):
    w = getattr(ctx, "spans", None)
    copies = 0 if w is None else sum(s[5]["copies"] for s in w.named(spans.PASS))
    if not copies:
        return None
    return (w.total_ns(spans.FEED) + w.total_ns(spans.SYNC)) / 1e3 / copies
