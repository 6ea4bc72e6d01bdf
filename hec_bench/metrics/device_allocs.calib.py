"""cudaMalloc calls of the caching allocator during the traced calibrate
call (calib.call's device_allocs count): whether the per-call capture
reallocates its memory pool."""
from hec_bench import spans


def read(ctx):
    return spans.count(ctx, "calib.call", "device_allocs")
