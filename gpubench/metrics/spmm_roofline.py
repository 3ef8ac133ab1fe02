"""spmm_roofline: the least time of an epoch's passes of Â over the device
time of the kernels that ran them, K1 and K2 together, in percent. The
passes are the family's train step (``pass_widths``) and eval forward
(``eval_pass_widths``); each pass's least time is ``spmm_pass`` of the
family's reference module (Â's CSR with bfloat16 values once, each
bfloat16 row of the operand once, each float32 output row written once,
against 3.35 TB/s; its products against the tensor cores' peak; the
larger), the same count whatever layout runs the pass. Nothing where the
family counts no such pass or no such kernel ran."""
from gpubench.trace import is_k2

K1 = "bsr_spmm_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not hasattr(ctx.family, "spmm_pass"):
        return None
    fam = ctx.family
    device_s = t.seconds(lambda name: name.startswith(K1) or is_k2(name))
    if device_s <= 0:
        return None
    widths = fam.pass_widths(ctx.config) + fam.eval_pass_widths(ctx.config)
    bound = t.steps * sum(fam.spmm_pass(ctx.graph, w).seconds for w in widths)
    return 100.0 * bound / device_s
