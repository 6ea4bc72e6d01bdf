"""Device milliseconds of one scoring silhouette (one hypothesis over the
batch's candidates) inside the traced explore call: the explore.render
device spans of the scoring graph, summed over the call, per silhouette."""
from hec_bench import spans


def read(ctx):
    return spans.device_ms_per_region(ctx, "explore.call", "explore.render")
