"""Device milliseconds of one bin state inside the traced explore call: the
explore.bin_state device spans of the scoring graph, summed over the call's
batches and hypotheses, per bin state."""
from hec_bench import spans


def read(ctx):
    return spans.device_ms_per_region(ctx, "explore.call", "explore.bin_state")
