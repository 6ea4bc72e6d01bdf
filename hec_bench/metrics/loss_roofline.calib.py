"""Per cent of its roofline that one mask-loss forward and backward
reaches over its device busy time (harness.device_ms):
render.fused.loss_fused and its backward to the twist at capture set 0's
ground truth, on a bin state built there before the timing, against the
bound of the work these inputs need (roofline.work.loss_work, from the
reference's projection)."""
import numpy as np
import torch

from hec_bench.reference import geometry as geo
from hec_bench.roofline import work


def read(ctx):
    t = ctx.traffic
    if getattr(t, "renderer", None) is None:
        return None
    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import tile_masks
    from easyhec_torch.render.fused import loss_fused

    r, dof, lp, K, masks = t.loss_inputs()
    ref_tiles = tile_masks(masks, r)
    st = r.bin_state(se3.exp(dof), lp, K)

    def step():
        d = dof.detach().requires_grad_(True)
        loss = loss_fused(r, se3.exp(d), lp, K, masks, 1.0, state=st, ref_tiles=ref_tiles).mean()
        return torch.autograd.grad(loss, d)

    ms = ctx.device_ms(step, reps=50)
    T64 = geo.se3_exp(torch.as_tensor(np.asarray(dof.cpu(), np.float64)))
    nbytes, ops = work.loss_work(t.ref, T64.to(t.ref.device),
                                 torch.as_tensor(t.sets[0]["lp"]).to(t.ref.device))
    return 100.0 * work.bound_ms(nbytes, ops) / ms
