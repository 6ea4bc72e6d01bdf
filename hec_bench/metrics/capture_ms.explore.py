"""Host milliseconds per traced explore call in its graph.* spans: the
scoring batch's warm-up and its capture (with torch's gc.collect and
empty_cache, and the instantiation)."""
from hec_bench import spans


def read(ctx):
    return spans.capture_ms(ctx, "explore.call")
