"""Device milliseconds of one rebin of rank 0's band in its traced sharded
calibration: the calib.rebin device spans of the step graph's conditional
body below shard.call, summed over the call's rebins, per rebin."""
from hec_bench import spans


def read(ctx):
    return spans.device_ms_per_region(ctx, "shard.call", "calib.rebin")
