"""Host milliseconds per traced calibrate call in its graph.* spans: the
step graph's warm-up, its two captures (each with torch's gc.collect and
empty_cache) and the conditional graph's instantiation."""
from hec_bench import spans


def read(ctx):
    return spans.capture_ms(ctx, "calib.call")
