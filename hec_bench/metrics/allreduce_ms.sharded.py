"""Device milliseconds of the combine's all-reduce of [loss, g0..g5] per
step in rank 0's traced sharded calibration: the shard.combine device spans
of the captured step, summed over the call, per step. A span runs from the
stream's last op before the collective to the stream's resuming after it,
so it holds the transfer and the wait for the slowest rank."""
from hec_bench import spans


def read(ctx):
    return spans.device_ms_per_region(ctx, "shard.call", "shard.combine")
