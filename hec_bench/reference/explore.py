"""The plain reference of one explorer call, in float64 where it computes:
the candidate draw from the call's key, the feasibility gates, and the
variance score

    variance[c] = Σ_pixels Var_h( silhouette(candidate c, hypothesis h) )

(population variance over the hypotheses, each silhouette the reference's
own, render.silhouette). The draw is the definition of the candidate set a
key stands for: one CPU torch.Generator seeded with the key gives the
hypothesis indices, then the uniform joint angles (the order of
easyhec_torch/models/explorer.py::draw_hypotheses_and_candidates). The
spheres of the self-collision gate are fitted as that file's
build_link_spheres:67 fits them (a frozen copy of the arithmetic). Imports
nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo
from .render import Scene, silhouette


def draw(key: int, n_hyp: int, n_hist: int, n_sample: int, lo, hi):
    g = torch.Generator(device="cpu").manual_seed(int(key))
    sel = torch.randint(0, n_hist, (n_hyp,), generator=g)
    lo_t = torch.as_tensor(lo, dtype=torch.float32)
    hi_t = torch.as_tensor(hi, dtype=torch.float32)
    u = torch.rand((n_sample, lo_t.shape[0]), generator=g)
    return sel.numpy(), (lo_t + u * (hi_t - lo_t)).numpy()


def spheres(raw: dict, names, per_link: int = 4, adjacent_skip: int = 1):
    """(centers [L, S, 3], radii [L, S], checked pairs [L, L]) of the links'
    meshes as read: S slices along each mesh's longest axis."""
    L = len(names)
    centers = np.zeros((L, per_link, 3), np.float32)
    radii = np.zeros((L, per_link), np.float32)
    for i, n in enumerate(names):
        v = raw[n][0]
        lo, hi = v.min(0), v.max(0)
        order = np.argsort(v[:, int(np.argmax(hi - lo))])
        for s, idx in enumerate(np.array_split(order, per_link)):
            if len(idx) == 0:
                continue
            pts = v[idx]
            c = (pts.min(0) + pts.max(0)) / 2
            centers[i, s] = c
            radii[i, s] = float(np.linalg.norm(pts - c, axis=1).max())
    ar = np.arange(L)
    return centers, radii, (ar[None, :] - ar[:, None]) > adjacent_skip


def feasible(robot, qpos, names, sph, max_dist: float, margin: float = 0.0) -> np.ndarray:
    """[C] bool: no checked sphere pair closer than ``margin`` and every link
    origin within ``max_dist`` of the root's, at joint angles qpos [C, n]."""
    all_names = list(robot.links)
    poses = geo.fk(robot, qpos, all_names)  # [C, n_links, 4, 4]
    org = poses[..., :3, 3]
    ok = np.all(np.linalg.norm(org - org[:, :1], axis=-1) <= max_dist, axis=-1)
    centers, radii, pair = sph
    sel = poses[:, [all_names.index(n) for n in names]]
    c = np.einsum("clij,lsj->clsi", sel[..., :3, :3], centers.astype(np.float64)) + sel[:, :, None, :3, 3]
    d = np.linalg.norm(c[:, :, :, None, None, :] - c[:, None, None, :, :, :], axis=-1)
    r = radii.astype(np.float64)
    rsum = r[:, :, None, None] + r[None, None, :, :]
    exists = (r > 0)[:, :, None, None] & (r > 0)[None, None, :, :]
    viol = (d - rsum < margin) & exists & pair[:, None, :, None]
    return ok & ~viol.reshape(len(qpos), -1).any(axis=1)


def variance(sc: Scene, robot, names, qpos, hyp_dofs, prec=None) -> np.ndarray:
    """[C] Σ_pixels Var_h of the silhouettes of candidates qpos [C, n] under
    the hypothesis twists hyp_dofs [Hh, 6]."""
    Tc = geo.se3_exp(torch.as_tensor(np.asarray(hyp_dofs, np.float64), device=sc.device))
    lp = geo.fk(robot, qpos, names)
    out = []
    for c in range(len(qpos)):
        lpc = torch.as_tensor(lp[c], device=sc.device).expand(Tc.shape[0], -1, -1, -1)
        s = silhouette(sc, Tc, lpc, prec)  # [Hh, H, W]
        out.append(float(((s - s.mean(0)) ** 2).mean(0).sum()))
    return np.asarray(out)
