"""Device milliseconds of one RobotRenderer.bin_state at the cell's scoring
batch and a hypothesis pose: the device busy time of calls to it over a
trace of CUDA activity (harness.device_ms). CUDA events around the same
calls read the host's pace: each call enqueues more kernels than the
launch queue holds ahead of the card."""


def read(ctx):
    t = ctx.traffic
    if getattr(t, "explorer", None) is None:
        return None
    r, T, lp, K, _ = t.scoring_batch()
    return ctx.device_ms(lambda: r.bin_state(T, lp, K), reps=20)
