"""step_mfu: the whole step's roofline share, in percent: the least time
the step's required work takes over the device's own span of the traced
steps (from the start of the first device operation to the end of the
last, read from the trace; the gaps in which the card waits for the host
count, the host's start and final wait outside the span do not). The
work is ``step_work`` of the family's reference module, from the cell's
shapes (each op the larger of its bytes over 3.35 TB/s and its operations
over its peak); where the cell keeps chunks on the host, the larger of
that and their copies over the host link on every pass."""
from gpubench import yardstick


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps or t.span_s <= 0:
        return None
    passes = len(ctx.family.pass_widths(ctx.config))
    feed = yardstick.host_feed(ctx.graph, ctx.workload.get("device_share", 1.0), passes)
    least = yardstick.least_step_seconds(ctx.family.step_work(ctx.config, ctx.graph), feed)
    return 100.0 * least * t.steps / t.span_s
