"""Initial-pose estimation.

Counterpart of easyhec_tpu/models/pose_init.py:

- ``lookat_init``: the manual look-at path;
- ``global_search_init``: the render-and-score global search that replaces
  the reference's PVNet initializer. Candidate camera poses on a view
  sphere render at low resolution through a scoring renderer on the
  unfused route (K5), are scored by soft IoU against the observed masks,
  and the best ones are refined by mask moments and by Adam on the
  low-resolution mask loss (K5 forward and backward);
- ``ransac_pnp``: RANSAC over 6-point DLT hypotheses, all solved in one
  batched SVD on the device, then a refit on the best one's inliers. Its
  samples come from ``draw_ransac_samples`` (a CPU torch.Generator), not
  jax.random, so the two packages draw different hypotheses from one seed.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..geometry import camera, se3
from ..render.tiled import TileConfig
from ..solver.optim import make_optimizer

__all__ = ["lookat_init", "global_search_init", "GlobalSearchResult", "ransac_pnp",
           "draw_ransac_samples"]

_SCORE_BATCH = 64  # candidates per scoring render


def lookat_init(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-from-base extrinsic [4, 4] from an eye/target guess."""

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    return se3.inverse(camera.look_at(t(eye), t(target), t(up))).numpy()


@dataclasses.dataclass
class GlobalSearchResult:
    Tc_c2b: np.ndarray  # [4, 4] best pose
    score: float  # IoU of the best candidate after refinement
    scores: np.ndarray  # [n_candidates] IoU of every candidate
    poses: np.ndarray  # [n_candidates, 4, 4]
    # Share of the scoring renders' tile bins filled to the capacity
    # (triangles beyond it are dropped, as in the JAX package); counted on
    # the kernel route only.
    tiles_at_cap: float = 0.0


def _fibonacci_hemisphere(n: int, min_elev: float = 0.1) -> np.ndarray:
    """Quasi-uniform directions on the upper hemisphere (z >= sin(min_elev))."""
    i = np.arange(n, dtype=np.float64) + 0.5
    zlo = np.sin(min_elev)
    z = zlo + (1.0 - zlo) * (i / n)
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32)


def _mask_moments(mask: torch.Tensor):
    """(area, centroid u, centroid v) of a soft mask [..., H, W]."""
    H, W = mask.shape[-2:]
    area = mask.sum((-2, -1))
    us = torch.arange(W, dtype=torch.float32, device=mask.device) + 0.5
    vs = torch.arange(H, dtype=torch.float32, device=mask.device) + 0.5
    a = torch.clamp(area, min=1e-6)
    cu = (mask * us[None, :]).sum((-2, -1)) / a
    cv = (mask * vs[:, None]).sum((-2, -1)) / a
    return area, cu, cv


def _candidate_poses(target: np.ndarray, radii, n_dirs: int, n_roll: int) -> torch.Tensor:
    """[len(radii) * n_dirs * n_roll, 4, 4] camera-from-base candidates:
    look-at poses from a Fibonacci hemisphere of eyes around ``target``,
    each rolled about its optical axis, eye-major as the JAX package orders
    them (computed on the CPU in f32)."""
    dirs = _fibonacci_hemisphere(n_dirs)
    eyes = np.concatenate([target + float(r) * dirs for r in radii])
    rolls = np.linspace(0.0, 2 * np.pi, n_roll, endpoint=False, dtype=np.float32)
    tgt = torch.from_numpy(target)
    up = torch.tensor([0.0, 0.0, 1.0])
    out = []
    for eye in eyes:
        T = se3.inverse(camera.look_at(torch.from_numpy(eye), tgt, up))
        for roll in torch.from_numpy(rolls):
            c, s = torch.cos(roll), torch.sin(roll)
            z, o = torch.zeros(()), torch.ones(())
            Rz = torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]),
                              torch.stack([z, z, o])])
            Tr = T.clone()
            Tr[:3, :3] = Rz @ T[:3, :3]
            Tr[:3, 3] = Rz @ T[:3, 3]
            out.append(Tr)
    return torch.stack(out)


def global_search_init(
    renderer,
    link_poses: np.ndarray,  # [B, L, 4, 4] FK per frame (or [L, 4, 4])
    K: np.ndarray,
    masks: np.ndarray,  # [B, H, W] observed masks (or [H, W])
    radii=(0.6, 1.0, 1.5),
    n_dirs: int = 128,
    n_roll: int = 8,
    target: np.ndarray | None = None,
    downscale: int = 8,
    moment_iters: int = 2,
    topk: int = 16,
    refine_steps: int = 200,
    refine_lr: float = 2e-2,
    max_score_frames: int = 4,
) -> GlobalSearchResult:
    """Render-and-score global pose search, on the renderer's device.

    1. Sweep: candidates = view directions (Fibonacci hemisphere) × radii ×
       rolls about the optical axis, looking at the arm centroid. Each
       candidate renders at 1/downscale resolution over up to
       max_score_frames frames, 64 candidates per render (the JAX
       package's lax.map batch); score = mean soft IoU.
    2. Moment refine: the topk candidates get closed-form translation
       updates matching mask area (depth) and centroid (image offset), all
       at once, moment_iters times.
    3. Gradient refine: Adam (optax.adam(refine_lr): b1 0.9, b2 0.999, eps
       1e-8) on all topk se(3) poses at once, on the gradient of the sum of
       their multi-frame low-resolution mask losses; the best final IoU
       wins.
    """
    from .calib import downscale_K

    dev = renderer.device
    link_poses = np.asarray(link_poses, np.float32)
    masks = np.asarray(masks, np.float32)
    if link_poses.ndim == 3:
        link_poses = link_poses[None]
    if masks.ndim == 2:
        masks = masks[None]
    Bs = min(masks.shape[0], max_score_frames)
    lp = torch.tensor(link_poses[:Bs], device=dev)
    H, W = masks.shape[-2:]
    Hs, Ws = H // downscale, W // downscale
    Ks = torch.tensor(downscale_K(np.asarray(K), downscale), device=dev)
    m = masks[:Bs, : Hs * downscale, : Ws * downscale]
    masks_lo = torch.tensor(m.reshape(Bs, Hs, downscale, Ws, downscale).mean((2, 4)),
                            device=dev)

    if target is None:
        target = link_poses[:Bs, :, :3, 3].mean((0, 1))
    target = np.asarray(target, np.float32)
    poses = _candidate_poses(target, radii, n_dirs, n_roll).to(dev)
    score_renderer = _scoring_renderer(renderer, Hs, Ws)
    cap = score_renderer.tile.capacity

    def iou(sil):  # [..., Bs, Hs, Ws] -> [...]
        inter = torch.minimum(sil, masks_lo).sum((-2, -1))
        union = torch.maximum(sil, masks_lo).sum((-2, -1))
        return (inter / torch.clamp(union, min=1e-6)).mean(-1)

    # 1. sweep (through a bin state on the kernel route, to count the tiles
    # at capacity; mode="brute" and use_pallas=False render without one)
    stateful = score_renderer.kernel_route
    scores, full, tiles = [], 0, 0
    with torch.no_grad():
        for s in range(0, poses.shape[0], _SCORE_BATCH):
            T = poses[s:s + _SCORE_BATCH, None]  # [n, 1, 4, 4] against [Bs] frames
            lpb = lp.expand((T.shape[0],) + lp.shape)
            st = score_renderer.bin_state(T, lpb, Ks) if stateful else None
            if st is not None:
                full += int((st.counts >= cap).sum())
                tiles += st.counts.numel()
            scores.append(iou(score_renderer.silhouette(T, lpb, Ks, bin_state=st)))
    scores = torch.cat(scores)
    order = torch.argsort(-scores, stable=True)[:topk]

    # 2. moment refine, all candidates at once (frame 0)
    Tc = poses[order]
    tgt = torch.from_numpy(target).to(dev)
    fx, fy, cx, cy = Ks[0, 0], Ks[1, 1], Ks[0, 2], Ks[1, 2]
    with torch.no_grad():
        a_o, cu_o, cv_o = _mask_moments(masks_lo[0])
        for _ in range(moment_iters):
            a_r, _, _ = _mask_moments(score_renderer.silhouette(Tc, lp[0], Ks))
            sc = torch.sqrt(torch.clamp(a_r, min=1e-6) / torch.clamp(a_o, min=1e-6))
            c_c = Tc[:, :3, :3] @ tgt + Tc[:, :3, 3]  # [k, 3]
            z_new = c_c[:, 2] * sc
            x_new = (cu_o - cx) * z_new / fx
            y_new = (cv_o - cy) * z_new / fy
            t_new = Tc[:, :3, 3] + (torch.stack([x_new, y_new, z_new], dim=-1) - c_c)
            Tc = Tc.clone()
            Tc[:, :3, 3] = t_new

    # 3. gradient refine: Adam on every candidate at once
    dofs = se3.log(Tc).detach()
    opt = make_optimizer("adam", max_lr=refine_lr, total_steps=refine_steps)
    state = opt.init(dofs)
    for _ in range(refine_steps):
        d = dofs.detach().requires_grad_(True)
        sil = score_renderer.silhouette(se3.exp(d)[:, None], lp.expand((d.shape[0],) + lp.shape),
                                        Ks)
        loss = ((sil - masks_lo) ** 2).sum((-2, -1)).mean(-1).sum()
        (g,) = torch.autograd.grad(loss, d)
        upd, state = opt.update(g, state, dofs)
        dofs = (dofs + upd).detach()
    with torch.no_grad():
        ious = iou(score_renderer.silhouette(se3.exp(dofs)[:, None],
                                             lp.expand((dofs.shape[0],) + lp.shape), Ks))
    best = int(torch.argmax(ious))
    return GlobalSearchResult(
        Tc_c2b=se3.exp(dofs[best]).cpu().numpy(),
        score=float(ious[best]),
        scores=scores.cpu().numpy(),
        poses=poses.cpu().numpy(),
        tiles_at_cap=full / max(tiles, 1),
    )


def _scoring_renderer(renderer, Hs: int, Ws: int):
    """Low-resolution renderer sharing the packed meshes of ``renderer``,
    with the raw TileConfig defaults beyond tile size, capacity and
    use_pallas, as in the JAX package: the unfused route (K5), margin 1.0,
    no backface culling, the auto rect window and no big-span class."""
    r = copy.copy(renderer)
    r.H, r.W = Hs, Ws
    r.tile = TileConfig(
        min(renderer.tile.tile_h, Hs),
        min(renderer.tile.tile_w, max(Ws, 8)),
        renderer.tile.capacity,
        renderer.tile.use_pallas,
    )
    return r


def draw_ransac_samples(seed: int, N: int, n_iters: int,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """[n_iters, 6] int64: six distinct correspondence indices per
    hypothesis, from a CPU torch.Generator (seeded with ``seed`` unless one
    is given), whatever device the solve runs on."""
    gen = generator if generator is not None else torch.Generator().manual_seed(int(seed))
    return torch.rand((n_iters, N), generator=gen).argsort(dim=-1)[:, :6]


def ransac_pnp(
    pts3d: np.ndarray,  # [N, 3] in the base frame
    pts2d: np.ndarray,  # [N, 2] pixels
    K: np.ndarray,
    n_iters: int = 256,
    inlier_px: float = 4.0,
    seed: int = 0,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized RANSAC + DLT PnP, on ``device`` (None = CUDA). Returns
    (Tc_c2b [4, 4], inlier mask [N]).

    Each hypothesis is the smallest right singular vector of its 12×12 DLT
    system, reshaped to P = [M | p]; the SVD hands it back with either sign,
    so P is taken with det(M) > 0 (the sign under which it is λ[R | t], λ >
    0) before M is orthonormalized, and no hypothesis depends on the SVD's
    sign or order. R is M's nearest proper rotation, t = p / (mean singular
    value), both flipped if most points fall behind the camera. Inliers
    reproject within ``inlier_px``; the hypothesis with the most wins (the
    first on a tie) and is refit on its inliers when it has six or more."""
    dev = resolve_device(device)
    pts3d = torch.as_tensor(np.asarray(pts3d, np.float32), device=dev)
    pts2d = torch.as_tensor(np.asarray(pts2d, np.float32), device=dev)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    N = pts3d.shape[0]
    if N < 6:
        raise ValueError("ransac_pnp needs >= 6 correspondences")
    xy = (pts2d - Kt[:2, 2]) / torch.stack([Kt[0, 0], Kt[1, 1]])  # normalized coords

    def dlt(idx):
        """[..., k] correspondence indices -> (R [..., 3, 3], t [..., 3])."""
        X, x = pts3d[idx], xy[idx]
        Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # [..., k, 4]
        z = torch.zeros_like(Xh)
        A = torch.cat([torch.cat([Xh, z, -x[..., :1] * Xh], dim=-1),
                       torch.cat([z, Xh, -x[..., 1:2] * Xh], dim=-1)], dim=-2)
        P = torch.linalg.svd(A, full_matrices=False).Vh[..., -1, :].reshape(
            idx.shape[:-1] + (3, 4))
        P = P * torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)[..., None, None]
        U, S, Vh = torch.linalg.svd(P[..., :3])
        sign = torch.sign(torch.linalg.det(U @ Vh))
        D = torch.ones(sign.shape + (3,), dtype=sign.dtype, device=dev)
        D[..., 2] = sign
        R = (U * D[..., None, :]) @ Vh
        scale = sign * S.mean(dim=-1)
        t = P[..., 3] / torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12),
                                    scale)[..., None]
        zc = (pts3d @ R.transpose(-1, -2) + t[..., None, :])[..., 2]  # [..., N]
        flip = torch.sign(torch.sign(zc).sum(dim=-1))
        flip = torch.where(flip == 0, torch.ones_like(flip), flip)
        return R * flip[..., None, None], t * flip[..., None]

    idxs = draw_ransac_samples(seed, N, n_iters).to(dev)
    Rs, ts = dlt(idxs)
    uv, zc = camera.project_points(Kt, pts3d @ Rs.transpose(-1, -2) + ts[:, None, :])
    err = torch.linalg.norm(uv - pts2d, dim=-1)
    inliers = torch.where(zc > 0, err, torch.full_like(err, float("inf"))) < inlier_px
    best = int(torch.argmax(inliers.sum(dim=-1)))
    R, t, inl = Rs[best], ts[best], inliers[best]
    if int(inl.sum()) >= 6:  # refit on every inlier of the best hypothesis
        R, t = dlt(torch.nonzero(inl).flatten())
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.cpu().numpy()
    T[:3, 3] = t.cpu().numpy()
    return T, inl.cpu().numpy()
