"""k2_batched_share: the share of the chunks that the second traced
window's ``pass`` spans reduced inside run launches (their ``batched``, one
K2 launch over a run of cached chunks) of all the chunks they reduced
(their ``chunks``), in percent (``gpubench/spans.py``)."""
from gpubench import spans


def read(ctx):
    w = getattr(ctx, "spans", None)
    if w is None or not w.chunks():
        return None
    return 100.0 * sum(s[5]["batched"] for s in w.named(spans.PASS)) / w.chunks()
