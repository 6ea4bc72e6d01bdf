"""Bin states built per explore call (SpaceExplorer.last_bin_states, which
counts graph replays), mean over the window's calls."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["bin_states"] for r in ctx.records) / len(ctx.records)
