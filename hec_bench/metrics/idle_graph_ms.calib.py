"""Device-idle milliseconds per traced calibrate call while a chunk of step
graph replays is in flight, from its calib.chunk.queue's start to its
calib.chunk.read's end: the gaps between the graph's nodes and between its
replays (spans.idle_split). The host sits mostly in the queue span there
when traced, blocked in the launches.

The profiler sets most of this number. On an H100, CUDA events around each
step replay read 0.82-0.93 ms a step untraced and 1.28-1.41 ms under CUDA
activity tracing, while the step's kernels stay busy 0.70-0.78 ms: the
traced call holds four to six times the gaps of an untraced one (PERF.md
section 3). A change that removes nodes shows here more than in calib_s."""
from hec_bench import spans


def read(ctx):
    split = spans.idle_split(ctx, "calib.call", "calib.chunk.queue", "calib.chunk.read")
    return split[0] if split else None
