"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over set-up and the
window, in GiB (read before the reference runs)."""


def read(ctx):
    if ctx.trace is not None or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30
