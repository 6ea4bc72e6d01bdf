"""End result: Adam on the brute-force silhouette recovers a camera pose
offset, on the CPU.

Counterpart of tests/test_tiled.py:255
(``TestRobotRenderer.test_pose_optimization_convergence``, marked slow
there), on its rig and with its thresholds: a box and a cylinder at 64×64
through ``RobotRenderer(mode="brute")``, the camera 1.2 m in front of the
base (f = 80), three link configurations (the second link rotated by 1 rad
about y and moved to [0.2, 0.1, 0.25], or moved to [-0.25, 0.15, 0.1]), the
target rendered at the GT pose; 200 steps of the port's Adam at lr 3e-3
(``solver.optim.make_optimizer``, optax.adam's update) on Σ(image −
target)² from the GT + [0.03, -0.02, 0.04, 0.02, -0.01, 0.02]. The loss
must fall below 5 % of its start and every se(3) component end within 0.01
of the GT's.
"""
import numpy as np
import torch

from easyhec_torch.geometry import se3
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.robot import make_box, make_cylinder
from easyhec_torch.solver.optim import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

STEPS = 200


def test_pose_optimization_convergence():
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    r = RobotRenderer(meshes, H=64, W=64, tile=TileConfig(tile_h=16, tile_w=32, capacity=64),
                      mode="brute", device="cpu")
    lp = torch.eye(4).repeat(2, 1, 1)
    lp[1, 2, 3] = 0.3
    lp2 = lp.clone()
    lp2[1, :3, :3] = se3.exp(torch.tensor([0.0, 0, 0, 0, 1.0, 0]))[:3, :3]
    lp2[1, :3, 3] = torch.tensor([0.2, 0.1, 0.25])
    lp3 = lp.clone()
    lp3[1, :3, 3] = torch.tensor([-0.25, 0.15, 0.1])
    lp = torch.stack([lp, lp2, lp3])  # [B=3, L, 4, 4]
    Tc = torch.eye(4)
    Tc[2, 3] = 1.2
    K = torch.tensor([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]])
    gt_xi = se3.log(Tc)
    with torch.no_grad():
        target = r.silhouette(se3.exp(gt_xi), lp, K)

    def loss(x):
        return torch.sum((r.silhouette(se3.exp(x), lp, K) - target) ** 2)

    opt = make_optimizer("adam", max_lr=3e-3, total_steps=STEPS)
    xi = gt_xi + torch.tensor([0.03, -0.02, 0.04, 0.02, -0.01, 0.02])
    state = opt.init(xi)
    losses = []
    for _ in range(STEPS):
        x = xi.clone().requires_grad_()
        v = loss(x)
        (g,) = torch.autograd.grad(v, x)
        updates, state = opt.update(g, state, xi)
        xi = xi + updates
        losses.append(float(v.detach()))
    assert losses[-1] < 0.05 * losses[0], losses[::20]
    err = np.abs((xi - gt_xi).numpy())
    assert err[:3].max() < 0.01, err  # <1cm translation
    assert err[3:].max() < 0.01, err  # <0.6deg rotation
