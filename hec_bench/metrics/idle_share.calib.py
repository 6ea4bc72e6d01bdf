"""Per cent of the traced window with no device op running (CUDA activity
only): 1 - union of the ops' intervals / the window."""


def read(ctx):
    return ctx.trace.idle_share() if ctx.trace is not None else None
