"""Bin states built per sharded calibration on the mesh: the shard.call
count ``rebins``, each chunk's largest rank count summed over the call
(every rank builds its own; the all-reduce of each step waits for the
slowest), mean over the traced calls."""
from hec_bench import spans


def read(ctx):
    return spans.count(ctx, "shard.call", "rebins")
