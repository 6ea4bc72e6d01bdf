"""A configuration's inputs, made by the benchmark from the seed: the arm's
triangles, the camera rig, capture sets of joint angles with their link
poses and masks, and pose histories. The program under test and the
reference are handed the same numbers; the masks are the reference's
silhouettes at the ground-truth pose, thresholded at 0.5. The rig and the
frames follow chip_smoke.py::build_scene (:269) and iterative_rig (:3020),
rewritten as data in configs/.

Imports nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .harness import HERE
from .reference import geometry as geo
from .reference.render import Scene, silhouette


@dataclass
class Arm:
    robot: geo.Robot
    names: list
    meshes: dict  # name -> (vertices [V, 3] f32, faces [F, 3] i32), subdivided
    raw: dict  # name -> the link's visuals as read, not subdivided

    def corners(self):
        return geo.corners(self.meshes, self.names)


def arm(cfg: dict) -> Arm:
    a = cfg["arm"]
    robot = geo.read_urdf(HERE / a["urdf"])
    return Arm(robot, list(a["links"]), geo.link_meshes(robot, a["links"], a["max_edge"]),
               geo.link_meshes(robot, a["links"], 0.0))


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def camera(cfg: dict, g: np.random.Generator) -> np.ndarray:
    """Ground-truth camera-from-base [4, 4] (float64): the rig's look_at,
    eye and target jittered by the configuration's ``jitter_m``."""
    r = cfg["rig"]
    j = float(r["jitter_m"])
    eye = np.asarray(r["eye"]) + g.uniform(-j, j, 3)
    target = np.asarray(r["target"]) + g.uniform(-j, j, 3) / 2
    return geo.look_at_np(eye, target)


def qposes(a: Arm, g: np.random.Generator, n: int, frac: float) -> np.ndarray:
    lim = a.robot.limits.astype(np.float64) * frac
    return g.uniform(lim[:, 0], lim[:, 1], (n, len(lim))).astype(np.float32)


def ref_scene(cfg: dict, a: Arm, K, H=None, W=None, device="cpu") -> Scene:
    c, ids = a.corners()
    return Scene(c, ids, H or cfg["H"], W or cfg["W"], K,
                 cull=cfg["render"]["cull_backfaces"], sharpness=cfg["render"]["sharpness"],
                 device=device)


def capture_set(cfg: dict, a: Arm, sc: Scene, g: np.random.Generator, frames: int) -> dict:
    """One capture set: qpos [B, n_dof] f32, link poses [B, L, 4, 4] (f64),
    the ground-truth camera, its twist, and binary masks [B, H, W] (f32)."""
    q = qposes(a, g, frames, float(cfg["qpos_fraction"]))
    lp = geo.fk(a.robot, q.astype(np.float64), a.names)
    lp = lp.astype(np.float32).astype(np.float64)  # the program gets them as float32
    Tc = camera(cfg, g)
    with torch.no_grad():
        sil = silhouette(sc, torch.as_tensor(Tc), torch.as_tensor(lp))
    masks = (sil > 0.5).to(torch.float32)
    return {"qpos": q, "lp": lp, "Tc": Tc, "xi": geo.se3_log_np(Tc), "masks": masks}


def unit_twist(g: np.random.Generator) -> np.ndarray:
    d = g.normal(size=6)
    return d / np.linalg.norm(d)
