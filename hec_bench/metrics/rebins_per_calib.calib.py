"""Bin states built per calibration (CalibResult.rebins, which counts the
conditional rebin node's replays), mean over the window's calls."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["rebins"] for r in ctx.records) / len(ctx.records)
