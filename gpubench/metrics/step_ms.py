"""step_ms: the window's wall time over the training steps it completed
(each step forward, backward and Adam, ended by the loss's ``.item()``),
in milliseconds; host clock, steps back to back."""


def read(ctx):
    if ctx.trace is not None or not ctx.steps:
        return None
    return 1e3 * ctx.window_s / ctx.steps
