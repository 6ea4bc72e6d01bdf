"""Host milliseconds per traced sharded calibration in its shard.flags
spans: after each chunk, the max-reduce of the overflow flag and the rebin
count over the mesh and its host read."""
from hec_bench import spans


def read(ctx):
    sp = spans.in_window(ctx.trace)
    calls = spans.named(sp, "shard.call")
    if not calls:
        return None
    flags = [s for s in spans.subtree(sp, calls) if s.name == "shard.flags"]
    return sum(s.end_ns - s.start_ns for s in flags) / 1e6 / len(calls)
