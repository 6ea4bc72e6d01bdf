"""Per cent of rank 0's traced sharded calibrations (their shard.call
spans) with no device op of rank 0's card running: 1 - the union of the
ops' intervals inside the spans / the spans' time. Waits for other ranks
inside a collective count as busy (NCCL's kernel runs)."""
from hec_bench import spans


def read(ctx):
    calls = spans.named(spans.in_window(ctx.trace), "shard.call")
    if not calls:
        return None
    busy = sum(max(0, min(e, c.end_ns) - max(s, c.start_ns))
               for c in calls for s, e in ctx.trace.busy_intervals())
    total = sum(c.end_ns - c.start_ns for c in calls)
    return 100.0 * (1.0 - busy / total)
