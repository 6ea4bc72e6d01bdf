"""Per cent of its roofline that one scoring silhouette reaches over its
device busy time (harness.device_ms): the explorer's render of one
scoring batch at a hypothesis pose through the port's entry (render.fused.silhouette_compact on a bin state built before
the timing), against the bound of the work these inputs need
(roofline.work.silhouette_work, from the reference's projection)."""
import numpy as np
import torch

from hec_bench.reference import geometry as geo
from hec_bench.roofline import work


def read(ctx):
    t = ctx.traffic
    if getattr(t, "explorer", None) is None:
        return None
    from easyhec_torch.render.fused import silhouette_compact

    r, T, lp, K, q = t.scoring_batch()
    with torch.no_grad():
        st = r.bin_state(T, lp, K)
        ms = ctx.device_ms(lambda: silhouette_compact(r, T, K, st), reps=50)
    T64 = geo.se3_exp(torch.as_tensor(t.history[-1].astype(np.float64)))
    lp64 = torch.as_tensor(geo.fk(t.arm.robot, q, t.arm.names))
    nbytes, ops = work.silhouette_work(t.ref, T64.to(t.ref.device), lp64.to(t.ref.device))
    return 100.0 * work.bound_ms(nbytes, ops) / ms
