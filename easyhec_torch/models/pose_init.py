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
from ..utils import cuda_graph
from ..utils.profiling import span

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


def _candidate_poses(target: np.ndarray, radii, n_dirs: int, n_roll: int,
                     device=None) -> torch.Tensor:
    """[len(radii) * n_dirs * n_roll, 4, 4] camera-from-base candidates on
    ``device``: look-at poses from a Fibonacci hemisphere of eyes around
    ``target``, each rolled about its optical axis (an in-plane rotation
    left-multiplied onto R and t), eye-major as the JAX package orders
    them; one batched computation in f32."""
    dirs = _fibonacci_hemisphere(n_dirs)
    eyes = np.concatenate([target + float(r) * dirs for r in radii])
    rolls = np.linspace(0.0, 2 * np.pi, n_roll, endpoint=False, dtype=np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    T = se3.inverse(camera.look_at(t(eyes), t(target), t([0.0, 0.0, 1.0])))  # [E, 4, 4]
    c, s = torch.cos(t(rolls)), torch.sin(t(rolls))
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Rz = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)[None]  # [1, n_roll, 3, 3]
    R, tr = T[:, None, :3, :3], T[:, None, :3, 3:]
    return se3.from_rt(Rz @ R, (Rz @ tr)[..., 0]).reshape(-1, 4, 4)


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

    The JAX package compiles each stage. Here, on CUDA with the scoring
    renderer on the kernel route, each is a CUDA graph captured at this
    call, in one memory pool: the sweep's batch (replayed once per batch),
    the moment refine (replayed once) and the Adam step (calib._Scan,
    replayed refine_steps times). The host reads nothing until the final
    IoUs. mode="brute" and use_pallas=False render in plain PyTorch and run
    the same functions eagerly, as every route does on the CPU.

    Spans (utils.profiling): ``search.call``, and ``search.sweep``,
    ``search.moment_refine`` and ``search.grad_refine`` around the three
    stages (their capture and queued replays).
    """
    from .calib import downscale_K

    with span("search.call"):
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
        poses = _candidate_poses(target, radii, n_dirs, n_roll, dev)
        score_renderer = _scoring_renderer(renderer, Hs, Ws)

        def iou(sil):  # [..., Bs, Hs, Ws] -> [...]
            inter = torch.minimum(sil, masks_lo).sum((-2, -1))
            union = torch.maximum(sil, masks_lo).sum((-2, -1))
            return (inter / torch.clamp(union, min=1e-6)).mean(-1)

        with span("search.sweep"):
            scores, at_cap, sweep = _sweep(score_renderer, poses, lp, Ks, iou)
        pool = sweep.graph.pool() if sweep is not None else None  # the later stages share it
        order = torch.argsort(-scores, stable=True)[:topk]
        with span("search.moment_refine"):
            Tc = _moment_refine(score_renderer, poses[order], lp, Ks, masks_lo,
                                torch.from_numpy(target).to(dev), moment_iters, pool)
        lpk = lp.expand((Tc.shape[0],) + lp.shape)
        with span("search.grad_refine"):
            dofs = _grad_refine(score_renderer, se3.log(Tc), lpk, Ks, masks_lo, refine_steps,
                                refine_lr, pool)
        with torch.no_grad():
            ious = iou(score_renderer.silhouette(se3.exp(dofs)[:, None], lpk, Ks))
        best = int(torch.argmax(ious))
        full, tiles = at_cap.tolist()
        return GlobalSearchResult(
            Tc_c2b=se3.exp(dofs[best]).cpu().numpy(),
            score=float(ious[best]),
            scores=scores.cpu().numpy(),
            poses=poses.cpu().numpy(),
            tiles_at_cap=full / max(tiles, 1),
        )


def _sweep(score_renderer, poses, lp, Ks, iou):
    """Stage 1: every candidate's score, in batches of up to 64 (a ragged
    last batch padded with candidate 0, whose scores are dropped). One
    batch reads its poses through a device batch index and writes its
    scores, and on the kernel route (through a bin state) adds its real
    candidates' tiles at capacity and tiles to two device counts. On CUDA
    and the kernel route, one CUDA graph replayed per batch
    (utils.cuda_graph.repeat). -> (scores [n], [tiles at capacity, tiles]
    (0 off the kernel route), the graph or None)."""
    dev = poses.device
    n = poses.shape[0]
    cb = min(_SCORE_BATCH, n)
    nb = -(-n // cb)
    pad = nb * cb - n
    padded = torch.cat([poses, poses[:1].expand((pad, 4, 4))]) if pad else poses
    slot = torch.arange(cb, device=dev)
    lpb = lp.expand((cb,) + lp.shape)
    cap = score_renderer.tile.capacity
    stateful = score_renderer.kernel_route  # brute and use_pallas=False bin nothing
    bufs = dict(
        poses=padded.reshape(nb, cb, 1, 4, 4),  # [n, 1, 4, 4] against [Bs] frames
        bidx=torch.zeros(1, dtype=torch.int64, device=dev),
        scores=torch.zeros((nb, cb), dtype=torch.float32, device=dev),
        full=torch.zeros((), dtype=torch.int64, device=dev),
        tiles=torch.zeros((), dtype=torch.int64, device=dev),
    )

    @torch.no_grad()
    def batch(b):
        T = b["poses"].index_select(0, b["bidx"])[0]
        st = score_renderer.bin_state(T, lpb, Ks) if stateful else None
        if st is not None:
            live = (b["bidx"] * cb + slot < n)[:, None]  # the real candidates
            b["full"] += ((st.counts >= cap).reshape(cb, -1) & live).sum()
            b["tiles"] += live.sum() * (st.counts.numel() // cb)
        sil = score_renderer.silhouette(T, lpb, Ks, bin_state=st)
        b["scores"].index_copy_(0, b["bidx"], iou(sil)[None])
        b["bidx"] += 1

    graph = cuda_graph.repeat(batch, bufs, nb, cuda_graph.captures(dev) and stateful)
    return bufs["scores"].reshape(-1)[:n], torch.stack([bufs["full"], bufs["tiles"]]), graph


def _moment_refine(score_renderer, Tc, lp, Ks, masks_lo, target, iters, pool):
    """Stage 2: ``iters`` closed-form translation updates of the candidates
    Tc [k, 4, 4] from mask moments on frame 0 (area ratio -> depth scale,
    centroid -> image-plane shift). On CUDA and the kernel route, one CUDA
    graph of all iterations, captured in ``pool`` and replayed once. -> Tc
    [k, 4, 4]."""
    fx, fy, cx, cy = Ks[0, 0], Ks[1, 1], Ks[0, 2], Ks[1, 2]
    a_o, cu_o, cv_o = _mask_moments(masks_lo[0])

    @torch.no_grad()
    def moments(b):
        Tc = b["Tc"]
        for _ in range(iters):
            a_r, _, _ = _mask_moments(score_renderer.silhouette(Tc, lp[0], Ks))
            sc = torch.sqrt(torch.clamp(a_r, min=1e-6) / torch.clamp(a_o, min=1e-6))
            c_c = Tc[:, :3, :3] @ target + Tc[:, :3, 3]  # [k, 3]
            z_new = c_c[:, 2] * sc
            x_new = (cu_o - cx) * z_new / fx
            y_new = (cv_o - cy) * z_new / fy
            Tc[:, :3, 3] += torch.stack([x_new, y_new, z_new], dim=-1) - c_c

    bufs = dict(Tc=Tc.clone())
    cuda_graph.repeat(moments, bufs, 1,
                      cuda_graph.captures(Tc.device) and score_renderer.kernel_route, pool=pool)
    return bufs["Tc"]


def _grad_refine(score_renderer, dofs, lpk, Ks, masks_lo, steps, lr, pool):
    """Stage 3: ``steps`` Adam steps on all the se(3) poses dofs [k, 6] at
    once, on the sum of their mask losses: calib._Scan over the one step,
    with no bin state (the silhouette bins afresh each step); on CUDA and
    the kernel route captured as a CUDA graph in ``pool`` and replayed
    ``steps`` times. -> dofs [k, 6]."""
    from .calib import _Scan

    if steps <= 0:
        return dofs

    def loss_of(d, _):
        sil = score_renderer.silhouette(se3.exp(d)[:, None], lpk, Ks)
        return ((sil - masks_lo) ** 2).sum((-2, -1)).mean(-1).sum()

    opt = make_optimizer("adam", max_lr=lr, total_steps=steps)
    scan = _Scan(dofs, opt.init(dofs), opt, loss_of, None, steps, rebin_every=0)
    if cuda_graph.captures(dofs.device) and score_renderer.kernel_route:
        scan.capture(pool)
    scan.queue(steps)
    return scan.dof


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
