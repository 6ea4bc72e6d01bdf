"""End result: the port's global search finds the view of the mini arm, on
the CPU.

Counterpart of tests/test_pose_init.py:47
(``test_global_search_init_finds_viewpoint``, marked slow there), on its
rig and with its thresholds: the mini arm (``__graft_entry__.MINI_URDF``)
at q = [0.4, -0.5], 48×64 with ``TileConfig(16, 32, 64)`` and f = 80, the
GT a look-at from [0.7, 0.4, 0.6] to [0, 0, 0.25]; ``global_search_init``
on the GT silhouette with radii (0.6, 0.9, 1.2), 48 directions, 2 rolls,
downscale 2 and the top 4. The best refined IoU must exceed 0.3 and the
found camera centre lie within cos > 0.5 of the GT's direction from the
base.
"""
import tempfile

import numpy as np
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.models.pose_init import global_search_init, lookat_init
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

LINKS = ["base", "upper", "fore"]


def test_global_search_init_finds_viewpoint():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
    model = parse_urdf(f.name)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    renderer = RobotRenderer([meshes[n] for n in LINKS], 48, 64,
                             tile=TileConfig(16, 32, 64), device="cpu")
    lp = chain.fk(torch.tensor([0.4, -0.5]))[[chain.link_index(n) for n in LINKS]]
    T_gt = lookat_init(eye=[0.7, 0.4, 0.6], target=[0.0, 0.0, 0.25])
    K = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]], np.float32)
    with torch.no_grad():
        mask_gt = renderer.silhouette(torch.from_numpy(T_gt), lp, torch.from_numpy(K)).numpy()
    assert mask_gt.sum() > 20  # the arm is visible in the GT view

    res = global_search_init(renderer, lp.numpy(), K, mask_gt, radii=(0.6, 0.9, 1.2),
                             n_dirs=48, n_roll=2, downscale=2, topk=4)
    assert res.score > 0.3  # coarse init: good overlap, not exactness
    # the found camera center should be in the right half-space
    c_est = -res.Tc_c2b[:3, :3].T @ res.Tc_c2b[:3, 3]
    c_gt = -T_gt[:3, :3].T @ T_gt[:3, 3]
    assert np.dot(c_est / np.linalg.norm(c_est), c_gt / np.linalg.norm(c_gt)) > 0.5
