"""Device busy milliseconds per Adam step over the traced calibrations:
the union of the device ops' intervals (CUDA activity only) over the
traced window, divided by the steps those calls ran."""


def read(ctx):
    if ctx.trace is None or not ctx.records:
        return None
    steps = sum(len(r["losses"]) for r in ctx.records)
    return ctx.trace.busy_s * 1e3 / steps
