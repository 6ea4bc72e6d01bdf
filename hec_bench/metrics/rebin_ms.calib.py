"""Device milliseconds of one rebin in the traced calibrate call: the
calib.rebin device spans of the step graph's conditional body, summed over
the call's rebins, per rebin."""
from hec_bench import spans


def read(ctx):
    return spans.device_ms_per_region(ctx, "calib.call", "calib.rebin")
