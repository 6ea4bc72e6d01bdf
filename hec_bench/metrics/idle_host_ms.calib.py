"""Device-idle milliseconds per traced calibrate call outside its chunks in
flight, put down to the call's spans: the capture, the preparation, the
chunk boundaries, the copies out (spans.idle_split). Traced, the capture
and its warm-up run slower than untraced, so this reads above an untraced
call's host idle (PERF.md section 3)."""
from hec_bench import spans


def read(ctx):
    split = spans.idle_split(ctx, "calib.call", "calib.chunk.queue", "calib.chunk.read")
    return split[1] if split else None
