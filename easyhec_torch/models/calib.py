"""Pose calibration model — mask-loss optimization of the camera pose.

Torch counterpart of easyhec_tpu/models/calib.py. ``calibrate`` runs Adam
on the 6-dof se(3) camera pose; each step is one fused loss kernel call
(forward plus analytic backward to Tc[:3,:4]: ops/pose_raster.py on the
dense route, ops/pose_raster_compact.py on the compact one) on bin states that are rebuilt only when the projected drift of the probe
points exceeds the margin budget (adaptive rebinning, ``opt_scan``).

Where the JAX package runs ``lax.scan`` over a chunk of steps, this runs a
Python loop: PyTorch executes eagerly, and a rebin decision is one host
read of the drift scalar per step (the cost is in PERF.md; CUDA graphs are
the tool that would remove it). Steps still go in chunks of ``chunk`` (50):
overflow is checked and ``step_hook`` fires once per chunk, exactly as in
the JAX package, so states and traces line up across the two.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import se3
from ..ops.pose_raster import tile_image
from ..render.renderer import RobotRenderer
from ..solver.optim import make_optimizer

__all__ = [
    "BinOverflowError",
    "CalibResult",
    "mask_loss",
    "mask_loss_per_frame",
    "tile_masks",
    "pose_metrics",
    "adaptive_drift_budget",
    "drift_probe_points",
    "make_drift_probe_fn",
    "opt_scan",
    "calibrate",
    "render_outputs",
    "downscale_mask",
    "downscale_K",
    "calibrate_multires",
]


class BinOverflowError(RuntimeError):
    """A rasterizer tile bin (or compact-chunk budget) saturated during the
    optimization trajectory: triangles were dropped and the gradient is
    silently truncated. Raise render.capacity / compact_chunks /
    rect_y/rect_x, or increase model.decimate_voxel."""


@dataclass
class CalibResult:
    """Host-side result of one calibration run."""

    dof: np.ndarray  # [6] final se(3) parameters
    Tc_c2b: np.ndarray  # [4, 4]
    losses: np.ndarray  # [num_steps]
    history: np.ndarray  # [num_steps, 6] pose before each step
    metrics: dict[str, float]  # vs GT when available, else {}
    overflow: bool = False  # any bin overflow seen at any rebin of the run
    rebins: int = 0  # total bin builds over the run


def mask_loss(
    dof, renderer: RobotRenderer, link_poses, K, masks_ref,
    sharpness: float = 1.0, robust_delta: float = 0.0, bin_state=None,
    ref_tiles=None,
) -> torch.Tensor:
    """Σ_pixels (rendered − ref)² per frame, mean over frames (optionally a
    Huber rho on the per-frame error normalized by mask area)."""
    per_frame = mask_loss_per_frame(
        dof, renderer, link_poses, K, masks_ref, sharpness, bin_state, ref_tiles,
    )
    return _robust_mean(per_frame, masks_ref, robust_delta)


def mask_loss_per_frame(
    dof, renderer: RobotRenderer, link_poses, K, masks_ref,
    sharpness: float = 1.0, bin_state=None, ref_tiles=None,
) -> torch.Tensor:
    """Per-frame Σ_pixels (rendered − ref)² [..B] through the fused loss
    kernels, dense or compact as the bin state (or the tile config) says;
    the fused route is the only one ported."""
    if not renderer.tile.fused:
        raise NotImplementedError(
            "only the fused loss route is ported to easyhec_torch (ROADMAP.md)"
        )
    from ..render.fused import loss_fused

    return loss_fused(
        renderer, se3.exp(dof), link_poses, K, masks_ref, sharpness,
        state=bin_state, ref_tiles=ref_tiles,
    )


def _robust_mean(per_frame, masks_ref, robust_delta: float):
    if robust_delta > 0:
        area = torch.clamp(torch.sum(masks_ref, dim=(-2, -1)), min=1.0)
        norm = per_frame / area
        d = robust_delta
        rho = torch.where(norm <= d, norm, 2.0 * torch.sqrt(norm * d) - d)
        return torch.mean(rho * area)
    return torch.mean(per_frame)


def tile_masks(masks_ref, renderer: RobotRenderer):
    """Pre-tiled reference masks for the fused loss kernel (pass as
    mask_loss(..., ref_tiles=...))."""
    cfg = renderer.tile
    m = torch.as_tensor(masks_ref, dtype=torch.float32, device=renderer.device)
    return tile_image(m.reshape((-1,) + m.shape[-2:]), cfg.tile_h, cfg.tile_w)


def pose_metrics(dof, Tc_c2b_gt: np.ndarray) -> dict[str, float]:
    """Error metrics vs ground truth: err_x/y/z/err_trans (cm) and err_rot
    (deg) compare se(3)-log components as the reference does;
    err_trans_geodesic_cm / err_rot_geodesic_deg are metric distances."""
    if np.allclose(Tc_c2b_gt, np.eye(4)):
        return {}
    gt_dof = se3.log(torch.as_tensor(np.asarray(Tc_c2b_gt), dtype=torch.float32)).numpy()
    dof = np.asarray(torch.as_tensor(dof).detach().cpu())
    trans_err = np.abs(gt_dof[:3] - dof[:3]) * 100.0
    rot_err = np.abs(gt_dof[3:] - dof[3:]).max() / np.pi * 180.0
    T = se3.exp(torch.as_tensor(dof, dtype=torch.float32)).numpy()
    dT = np.linalg.inv(Tc_c2b_gt) @ T
    trans_geo = float(np.linalg.norm(dT[:3, 3]) * 100.0)
    cos = np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)
    return {
        "err_x": float(trans_err[0]),
        "err_y": float(trans_err[1]),
        "err_z": float(trans_err[2]),
        "err_trans": float(np.linalg.norm(trans_err)),
        "err_rot": float(rot_err),
        "err_trans_geodesic_cm": trans_geo,
        "err_rot_geodesic_deg": float(np.degrees(np.arccos(cos))),
    }


def adaptive_drift_budget(tile, sharpness: float) -> float:
    """Pixel budget of the adaptive-rebin drift guard: binning margin −
    soft-coverage band (0.5/sharpness) − 0.3 px safety. Non-positive means
    adaptive rebinning is not viable (callers rebin every step)."""
    band = 0.5 / max(float(sharpness), 1e-3)
    return float(tile.margin) - band - 0.3


def drift_probe_points(renderer: RobotRenderer, link_poses) -> torch.Tensor:
    """[P, 3] base-frame probe points: per-link mesh AABB corners and link
    origins under every frame's FK (corners bound the lever arm of every
    vertex under rotation-dominant updates)."""
    lp = link_poses.reshape((-1,) + link_poses.shape[-3:])  # [B, L, 4, 4]
    corners = torch.as_tensor(renderer.link_aabb_corners(), device=lp.device)
    R, t = lp[..., :3, :3], lp[..., :3, 3]
    pts = torch.einsum("blij,lcj->blci", R, corners) + t[:, :, None, :]
    origins = t[:, :, None, :]
    return torch.cat([pts, origins], dim=2).reshape(-1, 3)


def make_drift_probe_fn(probes: torch.Tensor, K: torch.Tensor):
    """probe_fn(dof) -> [P, 2] pixel positions of base-frame ``probes``
    under the pose se3.exp(dof) and intrinsics K (depth clamped at 0.05)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    def probe_fn(d):
        T = se3.exp(d)
        pc = probes @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp(pc[:, 2], min=0.05)
        return torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], dim=-1)

    return probe_fn


def opt_scan(dof, opt_state, opt, loss_of, bin_state_of, chunk: int,
             rebin_every: int = 1, probe_fn=None, drift_budget: float = 0.0):
    """``chunk`` optimizer steps with amortized rebinning.

    loss_of(dof, bin_state) -> scalar; bin_state_of(dof) -> bin state.
    Returns (dof, opt_state, losses [chunk], history [chunk, 6], overflow,
    rebins): overflow ORs the flag of every bin state built in the chunk,
    history is the pose BEFORE each update, rebins counts the bin builds.

    - rebin_every < 1: no bin states (overflow False, rebins 0).
    - ADAPTIVE (probe_fn and drift_budget > 0): the state is rebuilt before
      a render whenever probe drift from its build pose exceeds the budget.
    - fixed cadence: a fresh state every ``rebin_every`` steps; like the JAX
      version, the last window runs to its end and the trace is cut to
      ``chunk`` entries.
    """
    losses, history = [], []

    def step(dof, opt_state, state):
        d = dof.detach().requires_grad_(True)
        loss = loss_of(d, state)
        (g,) = torch.autograd.grad(loss, d)
        updates, opt_state = opt.update(g, opt_state, dof)
        losses.append(loss.detach())
        history.append(dof)
        return (dof + updates).detach(), opt_state

    def out(dof, opt_state, ov, nrb):
        return (dof, opt_state, torch.stack(losses[:chunk]),
                torch.stack(history[:chunk]), bool(ov), int(nrb))

    if rebin_every < 1:
        for _ in range(chunk):
            dof, opt_state = step(dof, opt_state, None)
        return out(dof, opt_state, False, 0)

    if probe_fn is not None and drift_budget > 0:
        state = bin_state_of(dof)
        pix = probe_fn(dof)
        ov, nrb = torch.any(state.overflow), 1
        for _ in range(chunk):
            drift = torch.max(torch.abs(probe_fn(dof) - pix))
            if bool(drift > drift_budget):  # one host read per step
                state = bin_state_of(dof)
                pix = probe_fn(dof)
                ov, nrb = ov | torch.any(state.overflow), nrb + 1
            dof, opt_state = step(dof, opt_state, state)
        return out(dof, opt_state, ov, nrb)

    inner = min(rebin_every, chunk)
    n_outer = -(-chunk // inner)
    ov = False
    for _ in range(n_outer):
        state = bin_state_of(dof)
        ov = ov | torch.any(state.overflow)
        for _ in range(inner):
            dof, opt_state = step(dof, opt_state, state)
    return out(dof, opt_state, ov, n_outer)


def _calibrate_chunk(dof, opt_state, opt, link_poses, K, masks_ref, ref_tiles,
                     renderer, chunk, sharpness, robust_delta, rebin_every):
    """``chunk`` optimization steps (the JAX package's one scan dispatch)."""

    def loss_of(d, bin_state):
        return mask_loss(d, renderer, link_poses, K, masks_ref, sharpness,
                         robust_delta, bin_state=bin_state, ref_tiles=ref_tiles)

    def bin_state_of(d):
        return renderer.bin_state(se3.exp(d), link_poses, K, sharpness=sharpness)

    # The compact fused route always reuses bin states, so even at
    # rebin_every=1 every step goes through an explicit state and its
    # overflow flag. rebin_every == 0 selects adaptive rebinning; a
    # non-positive drift budget makes it rebin every step instead.
    probe_fn = None
    budget = 0.0
    if rebin_every == 0:
        budget = max(adaptive_drift_budget(renderer.tile, sharpness), 0.0)
        if budget > 0:
            probe_fn = make_drift_probe_fn(drift_probe_points(renderer, link_poses), K)
    return opt_scan(dof, opt_state, opt, loss_of, bin_state_of, chunk,
                    max(1, rebin_every), probe_fn=probe_fn, drift_budget=budget)


def _calibrate_scan(
    init_dof, link_poses, K, masks_ref, renderer, num_steps, max_lr,
    optimizer_name, scheduler, grad_clip, sharpness, robust_delta=0.0,
    chunk=50, rebin_every=1, resume_state=None, step_hook=None,
    on_overflow="raise",
):
    opt = make_optimizer(optimizer_name, max_lr=max_lr, total_steps=num_steps,
                         scheduler=scheduler, grad_clip=grad_clip)
    dev = init_dof.device
    dof = init_dof
    opt_state = opt.init(init_dof)
    losses, history = [], []
    done = 0
    if resume_state is not None:
        dof = torch.as_tensor(np.asarray(resume_state["dof"]), dtype=torch.float32,
                              device=dev)
        leaves = opt.leaves(opt_state)
        opt_state = opt.from_leaves([
            torch.as_tensor(np.asarray(resume_state[f"opt_{i}"]), dtype=leaf.dtype,
                            device=dev)
            for i, leaf in enumerate(leaves)
        ])
        done = int(resume_state["step"])
        if done:
            losses.append(torch.as_tensor(np.asarray(resume_state["losses"]), device=dev))
            history.append(torch.as_tensor(np.asarray(resume_state["history"]), device=dev))
    ref_tiles = tile_masks(masks_ref, renderer)
    overflowed = False
    rebins = 0
    while done < num_steps:
        n = min(chunk, num_steps - done)
        dof, opt_state, l, h, ov, nrb = _calibrate_chunk(
            dof, opt_state, opt, link_poses, K, masks_ref, ref_tiles, renderer,
            n, sharpness, robust_delta, rebin_every,
        )
        losses.append(l)
        history.append(h)
        done += n
        rebins += nrb
        if on_overflow != "ignore" and ov:
            overflowed = True
            msg = (
                f"rasterizer bin overflow at step ~{done}: triangles were "
                "dropped and the pose gradient is truncated. Raise "
                "render.capacity / compact_chunks, widen rect_y/rect_x, or "
                "increase model.decimate_voxel."
            )
            if on_overflow == "raise":
                raise BinOverflowError(msg)
            logging.getLogger("easyhec_torch").warning(msg)
        if step_hook is not None:
            state = {"dof": dof.cpu().numpy(), "step": done}
            for i, leaf in enumerate(opt.leaves(opt_state)):
                state[f"opt_{i}"] = leaf.cpu().numpy()
            state["losses"] = torch.cat(losses).cpu().numpy()
            state["history"] = torch.cat(history).cpu().numpy()
            step_hook(done, state)
    return dof, torch.cat(losses), torch.cat(history), overflowed, rebins


def calibrate(
    init_dof,
    renderer: RobotRenderer,
    link_poses,
    K,
    masks_ref,
    num_steps: int = 1000,
    max_lr: float = 3e-3,
    optimizer: str = "adam",
    scheduler: str = "constant",
    grad_clip: float = 0.0,
    sharpness: float = 1.0,
    robust_delta: float = 0.0,
    rebin_every: int = 1,
    Tc_c2b_gt: np.ndarray | None = None,
    resume_state: dict | None = None,
    step_hook=None,
    on_overflow: str = "raise",
) -> CalibResult:
    """Run the mask-loss pose optimization on the renderer's device.

    resume_state: a dict previously passed to step_hook (dof, opt_* leaves,
    step, losses, history) — by this package or, through easyhec_torch.convert,
    by easyhec_tpu — continues an interrupted run. step_hook(done, state)
    fires after every chunk of 50 steps with the full resumable state.

    on_overflow: "raise" (default) raises BinOverflowError when any rebin of
    the trajectory saturates a bin; "warn" logs and continues; "ignore"
    skips the check.

    rebin_every: N > 0 = fixed cadence; 0 = ADAPTIVE (bins rebuilt exactly
    when probe drift exceeds the margin budget; see opt_scan).
    """
    dev = renderer.device

    def t(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=dev)

    dof, losses, history, overflowed, rebins = _calibrate_scan(
        t(init_dof), t(link_poses), t(K), t(masks_ref), renderer,
        int(num_steps), float(max_lr), optimizer, scheduler, float(grad_clip),
        float(sharpness), float(robust_delta), rebin_every=int(rebin_every),
        resume_state=resume_state, step_hook=step_hook, on_overflow=on_overflow,
    )
    dof_np = dof.cpu().numpy()
    return CalibResult(
        dof=dof_np,
        Tc_c2b=se3.exp(dof).cpu().numpy(),
        losses=losses.cpu().numpy(),
        history=history.cpu().numpy(),
        metrics=pose_metrics(dof_np, Tc_c2b_gt) if Tc_c2b_gt is not None else {},
        overflow=overflowed,
        rebins=rebins,
    )


def render_outputs(dof, renderer: RobotRenderer, link_poses, K, masks_ref,
                   sharpness: float = 1.0) -> dict[str, np.ndarray]:
    """Rendered / reference / |error| mask maps (host numpy), rendered by
    RobotRenderer.silhouette on the renderer's device."""
    dev = renderer.device

    def t(x):
        return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                               dtype=torch.float32, device=dev)

    with torch.no_grad():
        sil = renderer.silhouette(se3.exp(t(dof)), t(link_poses), t(K), sharpness)
    sil = sil.cpu().numpy()
    ref = t(masks_ref).cpu().numpy()
    return {"rendered_masks": sil, "ref_masks": ref, "error_maps": np.abs(sil - ref)}


def downscale_mask(masks: np.ndarray, s: int) -> np.ndarray:
    """Average-pool masks by integer factor s (soft targets at coarse scale)."""
    m = np.asarray(masks, np.float32)
    if s == 1:
        return m
    B, H, W = m.shape
    H2, W2 = H // s * s, W // s * s
    return m[:, :H2, :W2].reshape(B, H2 // s, s, W2 // s, s).mean(axis=(2, 4))


def downscale_K(K: np.ndarray, s: int) -> np.ndarray:
    """Intrinsics for an s-times downsampled image (pixel-center exact)."""
    K = np.asarray(K, np.float64).copy()
    if s != 1:
        K[0, 0] /= s
        K[1, 1] /= s
        K[0, 2] = (K[0, 2] + 0.5) / s - 0.5
        K[1, 2] = (K[1, 2] + 0.5) / s - 0.5
    return K.astype(np.float32)


def calibrate_multires(
    init_dof,
    renderers: dict[int, RobotRenderer],
    link_poses,
    K,
    masks_ref,
    steps_per_scale: dict[int, int],
    max_lr: float = 3e-3,
    optimizer: str = "adam",
    scheduler: str = "constant",
    grad_clip: float = 0.0,
    sharpness: float = 1.0,
    Tc_c2b_gt: np.ndarray | None = None,
) -> CalibResult:
    """Coarse-to-fine calibration: run at each scale s (descending) with
    renderers[s], K and masks downscaled by s, warm-starting the next."""
    dof = np.asarray(init_dof, np.float32)
    all_losses, all_hist = [], []
    for s in sorted(steps_per_scale, reverse=True):
        n = steps_per_scale[s]
        if n <= 0:
            continue
        res = calibrate(
            dof, renderers[s], link_poses, downscale_K(np.asarray(K), s),
            downscale_mask(np.asarray(masks_ref), s), num_steps=n, max_lr=max_lr,
            optimizer=optimizer, scheduler=scheduler, grad_clip=grad_clip,
            sharpness=sharpness,
        )
        dof = res.dof
        all_losses.append(res.losses)
        all_hist.append(res.history)
    return CalibResult(
        dof=dof,
        Tc_c2b=se3.exp(torch.as_tensor(dof)).numpy(),
        losses=np.concatenate(all_losses),
        history=np.concatenate(all_hist),
        metrics=pose_metrics(dof, Tc_c2b_gt) if Tc_c2b_gt is not None else {},
    )
