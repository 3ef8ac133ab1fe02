"""k2_roofline: K2's bound over its device time, in percent. The bound of
each pass is counted chunk by chunk from the shapes (``yardstick.k2_chunk``:
the chunk's CSR once, the distinct bf16 rows of x it gathers, the f32
accumulator rows written once, against 3.35 TB/s; 2 E F operations against
the f32 peak; the larger), for the passes of the family's step. A pass
starts from a zeroed accumulator and each chunk covers its own rows once,
so no base is read: the same count as the step's work in ``step_mfu``."""
from gpubench import yardstick
from gpubench.trace import is_k2


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    k2_s = t.seconds(is_k2)
    if k2_s <= 0:
        return None
    widths = ctx.family.pass_widths(ctx.config)
    bound = t.steps * sum(yardstick.k2_pass_seconds(ctx.graph, w) for w in widths)
    return 100.0 * bound / k2_s
