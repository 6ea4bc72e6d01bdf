"""A multi-camera rig's inputs, made by the benchmark from the seed: ring
cameras around the arm, the same captures seen from every view, each
view's known offset folded into the link poses, and masks from the
reference's silhouette at the ground truth. Configuration (5) of the
project (4 views x 20 frames at 1920x1080), as chip_smoke.py::config5_scene
(:3677) builds it, rewritten in float64 from the benchmark's own geometry.

The fold: view v sees frame lp through its camera-from-base Tc_v; with
lp' = inv(Tc0) Tc_v lp, Tc0 lp' = Tc_v lp, so one pose, view 0's, is solved
over every frame-view, and the bands and data shards of a mesh add up to
the one objective over all of them.

Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import scene
from .reference import geometry as geo
from .reference.render import silhouette


def ring_poses(views: int, radius: float, height: float, target) -> np.ndarray:
    """Camera-from-base [views, 4, 4] (float64) of eyes on a ring of
    ``radius`` around ``target`` and ``height`` above it, view v at angle
    2 pi v / views, each looking at ``target``."""
    t = np.asarray(target, np.float64)
    out = []
    for v in range(views):
        a = 2.0 * math.pi * v / views
        eye = t + np.array([radius * math.cos(a), radius * math.sin(a), height])
        out.append(geo.look_at_np(eye, t))
    return np.stack(out)


def fold(Tcs: np.ndarray, lp: np.ndarray) -> np.ndarray:
    """Link poses [V * F, L, 4, 4] (view-major) of frames lp [F, L, 4, 4]
    seen from cameras Tcs [V, 4, 4], with each view's offset from view 0
    folded in: inv(Tc0) Tc_v lp."""
    offs = np.einsum("ij,vjk->vik", np.linalg.inv(Tcs[0]), Tcs)
    return np.einsum("vij,fljk->vflik", offs, lp).reshape((-1,) + lp.shape[1:])


def capture_rig(cfg: dict, a: scene.Arm, sc, g: np.random.Generator,
                masks: bool = True) -> dict:
    """One rig's captures: qpos [F, n_dof] f32, the folded link poses
    [V * F, L, 4, 4] (float64 of the float32 the program gets), view 0's
    camera-from-base and twist (the ground truth), and (with ``masks``)
    binary masks [V * F, H, W] (f32, on the reference's device)."""
    r = cfg["rig"]
    q = scene.qposes(a, g, int(r["frames"]), float(cfg["qpos_fraction"]))
    Tcs = ring_poses(int(r["views"]), float(r["radius"]), float(r["height"]), r["target"])
    lp = fold(Tcs, geo.fk(a.robot, q.astype(np.float64), a.names))
    lp = lp.astype(np.float32).astype(np.float64)  # the program gets them as float32
    Tc = Tcs[0]
    out = {"qpos": q, "lp": lp, "Tc": Tc, "xi": geo.se3_log_np(Tc)}
    if masks:
        with torch.no_grad():
            out["masks"] = (silhouette(sc, torch.as_tensor(Tc), torch.as_tensor(lp)) > 0.5
                            ).to(torch.float32)
    return out
