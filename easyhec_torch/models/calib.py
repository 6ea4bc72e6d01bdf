"""Pose calibration model — mask-loss optimization of the camera pose.

Torch counterpart of easyhec_tpu/models/calib.py. ``calibrate`` runs Adam
on the 6-dof se(3) camera pose. On the fused route each step is one fused
loss kernel call (forward plus analytic backward to Tc[:3,:4]:
ops/pose_raster.py on the dense route, ops/pose_raster_compact.py on the
compact one); on the unfused route (``tile.fused=False``) it renders the
silhouette through K5 (ops/tile_raster.py) and autograd carries the
gradient through the record pack and the triangle setup to the pose. Bin
states are rebuilt only when the projected drift of the probe points
exceeds the margin budget (adaptive rebinning, ``opt_scan``).

On the fused route, with no Huber loss and make_optimizer's adam or sgd
over the pose (``_kernel_route``), a step runs no autograd: ops/step.py's
head kernel (the pose, the camera rows, the Jacobian of Tc[:3,:4] in the
twist), render/fused.py::loss_fused on its kernel route (the fused loss
kernels, then the grad kernel: [loss, g] under the frames' weights, which
are the gradient of the loss's reduction over frames, the empty tiles'
Σ ref² read from a per-call table) and the update kernel (the optimizer,
the traces, the pose and the next rebin flag); on the CPU their plain twins
run. Every other step differentiates the loss with autograd.

Where the JAX package compiles a chunk of steps into one program
(``lax.scan``, the rebin a ``lax.cond`` inside it), this captures one step
as a CUDA graph (``_Scan``, once per ``calibrate`` call) over static
tensors: the pose, the optimizer's leaves, the bin state, the probe pixels,
the flags and a device step index that writes the chunk's loss and pose
traces. The rebin is a conditional node at the head of the step graph: the
step's tail leaves the next step's rebin flag on the device (drift past the
budget, or a window's end) and the replay tests it there. A chunk is queued
as replays with no host read in between; the host reads the overflow flag
and the rebin count once per chunk, as the JAX package does. On the CPU the
same function runs eagerly. Steps go in chunks of ``chunk`` (50): overflow
is checked and ``step_hook`` fires once per chunk, exactly as in the JAX
package, so states and traces line up across the two.

Spans (utils.profiling): ``calib.call`` around ``calibrate`` (counts
``rebins``, ``kernel_steps``, the steps run on the kernel route, and, while a
torch profiler records, ``device_allocs``),
``calib.prepare`` (the optimizer and the tiled masks), per chunk
``calib.chunk.queue`` (queueing its steps) and ``calib.chunk.read`` (the host
read that waits for them), then ``calib.finish`` (the copies out). When a
torch profiler records the capture, the graph also times ``calib.rebin`` on
the device (utils.profiling.DeviceSpans), read after each chunk's read: the
chunk's rebins summed.
"""
from __future__ import annotations

import copy
import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import se3
from ..ops import step
from ..ops.pose_raster import tile_image
from ..render import fused
from ..render.renderer import RobotRenderer
from ..solver.optim import Optimizer, make_optimizer
from ..utils import cuda_graph
from ..utils.profiling import DeviceSpans, device_allocs, span

__all__ = [
    "BinOverflowError",
    "CalibResult",
    "mask_loss",
    "mask_loss_per_frame",
    "tile_masks",
    "reuse_bins_ok",
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


def _use_fused_loss(renderer: RobotRenderer) -> bool:
    return renderer.kernel_route and renderer.tile.fused


def mask_loss_per_frame(
    dof, renderer: RobotRenderer, link_poses, K, masks_ref,
    sharpness: float = 1.0, bin_state=None, ref_tiles=None,
) -> torch.Tensor:
    """Per-frame Σ_pixels (rendered − ref)² [..B]: through the fused loss
    kernels (dense or compact, as the bin state or the tile config says) on
    the fused route, else through RobotRenderer.silhouette (K5)."""
    if _use_fused_loss(renderer):
        from ..render.fused import CompactState, FusedState, loss_fused

        if bin_state is None or isinstance(bin_state, (FusedState, CompactState)):
            return loss_fused(
                renderer, se3.exp(dof), link_poses, K, masks_ref, sharpness,
                state=bin_state, ref_tiles=ref_tiles,
            )
    sil = renderer.silhouette(se3.exp(dof), link_poses, K, sharpness, bin_state=bin_state)
    return torch.sum((sil - masks_ref) ** 2, dim=(-2, -1))


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
    mask_loss(..., ref_tiles=...)); None off the fused route."""
    if not _use_fused_loss(renderer):
        return None
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


def reuse_bins_ok(renderer: RobotRenderer) -> bool:
    """Whether the renderer supports amortized rebinning (the counting
    binner, or the fused kernels, on the tiled route)."""
    return renderer.kernel_route and (renderer.tile.binner == "count" or renderer.tile.fused)


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
    under the pose se3.exp(dof) and intrinsics K (depth clamped at 0.05;
    ops.step.project_probes)."""

    def probe_fn(d):
        return step.project_probes(probes, se3.exp(d), K)

    return probe_fn


def _kernel_route(renderer: RobotRenderer, opt, robust_delta: float) -> bool:
    """Whether _Scan's step runs on ops/step.py's kernels around the fused
    loss kernels: the fused loss with its bin states (compact or dense), no
    Huber weights, and make_optimizer's own adam or sgd over the bare pose
    (an Optimizer with a ``spec``; the update kernel applies the spec, so
    any other object keeps its own ``update``). Elsewhere the step
    differentiates the loss with autograd."""
    return (_use_fused_loss(renderer) and robust_delta == 0
            and isinstance(opt, Optimizer) and opt.spec is not None)


def _frame_weights(batch, masks_ref, robust_delta: float, device) -> torch.Tensor:
    """[B] calibrate's frame weights on the kernel route: the gradient of its
    reduction over the frames' losses [*batch] (_robust_mean), linear where
    robust_delta == 0 (the mean, 1/B each), so its loss is Σ_b w_b loss_b."""
    x = torch.zeros(batch, dtype=torch.float32, device=device, requires_grad=True)
    (w,) = torch.autograd.grad(_robust_mean(x, masks_ref, robust_delta), x)
    return w.reshape(-1)


class _KernelStep:
    """The constants of _Scan's kernel route for one call: the renderer, the
    link poses, K and the sharpness; the tiled reference (float32) and, for
    compact states, its Σ ref² per tile (render/fused.py::tile_sq, made here
    once a call); the frames' weights w (the backward's cotangent, and the
    loss's weights); ``den`` (what loss and gradient are divided by after
    ``reduce``); ``reduce`` (None, or the mesh's in-place all-reduce of
    [loss, g]); the drift probes (_scan_for's, where adaptive); and the grad
    kernel's workspace on the card."""

    def __init__(self, renderer: RobotRenderer, link_poses, K, ref_tiles, sharpness, weights,
                 den: float = 1.0, reduce=None):
        B = weights.shape[0]
        f32 = torch.float32
        self.renderer, self.link_poses, self.sharpness = renderer, link_poses, float(sharpness)
        self.K = K.to(f32).contiguous()
        self.ref_tiles = ref_tiles.reshape((B,) + ref_tiles.shape[-3:]).to(f32).contiguous()
        self.ref_sq = fused.tile_sq(self.ref_tiles) if renderer.tile.compact_chunks > 0 else None
        self.w = weights.to(f32).contiguous()
        self.den, self.reduce = float(den), reduce
        self.probes = None
        self.work = step.grad_workspace(B, weights.device) if weights.is_cuda else None
        self.state_at = lambda Tc: renderer.bin_state(Tc, link_poses, K, sharpness=sharpness)

    def loss(self, b):
        """[loss, g] at the head's pose, camera rows and Jacobian in the
        buffers ``b``, written into b["gl"]: fused.loss_fused's kernel route."""
        g = fused.PoseGrad(self.w, self.ref_sq, b["cam"], b["jac"], b["gl"], self.work)
        return fused.loss_fused(self.renderer, b["Tc"], self.link_poses, self.K,
                                sharpness=self.sharpness, state=b["state"],
                                ref_tiles=self.ref_tiles, grad=g)


def _trace_len(chunk: int, rebin_every: int) -> int:
    """Steps a chunk runs: ``chunk``, or with a fixed cadence whole windows
    of ``rebin_every`` steps (the last runs to its end, as in the JAX
    package, and the trace is cut to ``chunk``)."""
    inner = min(max(rebin_every, 1), max(chunk, 1))
    return -(-chunk // inner) * inner


class _Scan:
    """opt_scan's loop over static tensors, held in ``bufs``: the pose, the
    optimizer's leaves, the loss and pose traces of a chunk (``length``
    entries), a device step index, the fixed cadence's window, the overflow
    flag, the rebin count, the rebin flag, and the bin state and probe
    pixels that ``_rebin`` adds. A turn is ``_rebin`` where the flag is
    set, then ``_step``, which leaves the next turn's flag on the device;
    both touch only those buffers, so they run eagerly (``_turn``) or, once
    ``capture``d, as one CUDA graph with the rebin its conditional node:
    the counterpart of the ``lax.cond`` inside the JAX package's scan. A
    chunk is then ``length`` replays and one host read. The buffers carry
    over from chunk to chunk.

    With ``kernel`` (a _KernelStep; the route _kernel_route picks) the step
    is ops/step.py's three kernels around the fused loss kernels, called
    directly (no autograd), over four more buffers: the pose Tc, the camera
    rows, the Jacobian and [loss, g]; the rebin takes its pose and probe
    pixels from the head kernel. ``kernel_steps`` counts the steps run so."""

    def __init__(self, dof, opt_state, opt, loss_of, bin_state_of, length: int,
                 rebin_every: int = 1, combine=None, probe_fn=None,
                 drift_budget: float = 0.0, kernel: _KernelStep | None = None):
        dev = dof.device
        self.opt, self.loss_of, self.bin_state_of = opt, loss_of, bin_state_of
        self.combine, self.probe_fn, self.budget = combine, probe_fn, float(drift_budget)
        self.rebin_every = rebin_every
        self.adaptive = rebin_every >= 1 and probe_fn is not None and drift_budget > 0
        self.bufs = dict(
            dof=dof.detach().clone(),
            leaves=[leaf.detach().clone() for leaf in opt.leaves(opt_state)],
            losses=torch.zeros(length, dtype=torch.float32, device=dev),
            history=torch.zeros((length,) + tuple(dof.shape), dtype=dof.dtype, device=dev),
            idx=torch.zeros(1, dtype=torch.int64, device=dev),  # step within the chunk
            inner=torch.ones((), dtype=torch.int64, device=dev),  # fixed cadence's window
            ov=torch.zeros((), dtype=torch.bool, device=dev),
            nrb=torch.zeros((), dtype=torch.int32, device=dev),
            need=torch.zeros((), dtype=torch.bool, device=dev),  # rebin before the next step
        )
        self.kernel, self.kernel_steps = kernel, 0
        if kernel is not None:
            f32 = dict(dtype=torch.float32, device=dev)
            self.bufs.update(Tc=torch.zeros((4, 4), **f32),
                             cam=torch.zeros((kernel.w.shape[0], 16), **f32),
                             jac=torch.zeros((12, 6), **f32), gl=torch.zeros(7, **f32))
            if self.adaptive:
                self.bufs["pix"] = torch.zeros((kernel.probes.shape[0], 2), **f32)
        self.device_spans = DeviceSpans(("calib.rebin",), dev)  # traced captures
        self.graph = None

    dof = property(lambda self: self.bufs["dof"])
    leaves = property(lambda self: self.bufs["leaves"])

    def _on(self, bufs):
        """This scan over ``bufs`` (its own, or the capture's warm-up copies)."""
        view = copy.copy(self)
        view.bufs = bufs
        return view

    def _rebin(self):
        b, k = self.bufs, self.kernel
        if k is None:
            b["state"] = self.bin_state_of(b["dof"])
            if self.adaptive:
                b["pix"] = self.probe_fn(b["dof"])
        else:  # the head kernel's pose and probe pixels, as the step's drift test reads them
            probes = (k.probes, b["pix"]) if self.adaptive else ()
            step.step_head(b["dof"], k.K, b["Tc"], b["cam"], b["jac"], *probes)
            b["state"] = k.state_at(b["Tc"])
        b["ov"] |= torch.any(b["state"].overflow)
        b["nrb"] += 1

    def _kernel_step(self):
        """The step on ops/step.py's kernels: the head (pose, camera rows,
        Jacobian), the fused loss kernels and the grad kernel ([loss, g];
        ``kernel.loss``), ``reduce`` on a mesh, then the update kernel
        (optimizer, traces, pose, step index, the next rebin flag)."""
        b, k = self.bufs, self.kernel
        step.step_head(b["dof"], k.K, b["Tc"], b["cam"], b["jac"])
        b["gl"] = k.loss(b)
        if k.reduce is not None:
            k.reduce(b["gl"])
        drift = (k.probes, k.K, b["pix"], self.budget) if self.adaptive else None
        step.step_update(b["gl"], k.den, self.opt, b["leaves"], b["dof"], b["losses"],
                         b["history"], b["idx"], b["need"], b["inner"], drift)

    def _step(self):
        if self.kernel is not None:
            return self._kernel_step()
        b = self.bufs
        d = b["dof"].detach().requires_grad_(True)
        if self.combine is None:
            loss = self.loss_of(d, b.get("state"))
            (g,) = torch.autograd.grad(loss, d)
        else:
            obj, true_local = self.loss_of(d, b.get("state"))
            (g,) = torch.autograd.grad(obj, d)
            loss, g = self.combine(true_local.detach(), g)
        updates, opt_state = self.opt.update(g, self.opt.from_leaves(b["leaves"]), b["dof"])
        b["losses"].index_copy_(0, b["idx"], loss.detach().reshape(1))
        b["history"].index_copy_(0, b["idx"], b["dof"][None])  # the pose BEFORE the update
        b["dof"].copy_(b["dof"] + updates)
        for buf, leaf in zip(b["leaves"], self.opt.leaves(opt_state)):
            buf.copy_(leaf)
        b["idx"] += 1
        # the next step's rebin flag, on the device
        if self.adaptive:  # the probes' drift from the state's build pose
            drift = torch.max(torch.abs(self.probe_fn(b["dof"]) - b["pix"]))
            torch.gt(drift, self.budget, out=b["need"])
        elif self.rebin_every >= 1:  # a window ends
            torch.eq(torch.remainder(b["idx"][0], b["inner"]), 0, out=b["need"])

    def _turn(self):
        """One turn eagerly: the host reads the rebin flag."""
        if self.rebin_every >= 1 and bool(self.bufs["need"]):
            self._rebin()
        self._step()

    def capture(self, pool=None) -> None:
        """Capture the turn (utils.cuda_graph.capture: a warm-up on copies of
        the buffers, then CondGraph(need, _rebin, _step), or Graph(_step) in
        ``pool`` for a scan without bin states); ``queue`` then replays it."""

        def rebin(b):  # a device span of a traced capture
            with self.device_spans.span("calib.rebin"):
                self._on(b)._rebin()

        self.graph = cuda_graph.capture(lambda b: self._on(b)._step(), self.bufs, pool=pool,
                                        cond=("need", rebin) if self.rebin_every >= 1 else None)

    def queue(self, chunk: int) -> None:
        """Queue ``chunk`` steps (a fixed cadence runs whole windows) from a
        fresh bin state, as the JAX package's chunk starts from state0.
        Captured, these are replays with no host read in between."""
        b = self.bufs
        inner = min(max(self.rebin_every, 1), chunk)
        for k in ("idx", "ov", "nrb"):
            b[k].zero_()
        b["need"].fill_(True)
        b["inner"].fill_(inner)
        steps = -(-chunk // inner) * inner
        for _ in range(steps):
            if self.graph is None:
                self._turn()
            else:
                self.graph.replay()
        if self.kernel is not None:
            self.kernel_steps += steps

    def run(self, chunk: int):
        """``chunk`` steps on from the buffers' pose and optimizer state ->
        (dof, opt_state, losses [chunk], history [chunk, 6], overflow,
        rebins), copies of the buffers: opt_scan's result. The overflow
        flag and the rebin count are the chunk's one host read, after which
        the device spans of a traced capture are read."""
        b = self.bufs
        with span("calib.chunk.queue"):
            self.queue(chunk)
        with span("calib.chunk.read"):
            ov, nrb = torch.stack([b["ov"].int(), b["nrb"].int()]).tolist()
            self.device_spans.read()
        if self.graph is not None and nrb:  # only a CondGraph rebins
            self.graph.taken(nrb)
        return (b["dof"].clone(), self.opt.from_leaves([t.clone() for t in b["leaves"]]),
                b["losses"][:chunk].clone(), b["history"][:chunk].clone(), bool(ov), nrb)


def opt_scan(dof, opt_state, opt, loss_of, bin_state_of, chunk: int,
             rebin_every: int = 1, combine=None, probe_fn=None,
             drift_budget: float = 0.0):
    """``chunk`` optimizer steps with amortized rebinning.

    loss_of(dof, bin_state) -> scalar; bin_state_of(dof) -> bin state.
    Returns (dof, opt_state, losses [chunk], history [chunk, 6], overflow,
    rebins): overflow ORs the flag of every bin state built in the chunk,
    history is the pose BEFORE each update, rebins counts the bin builds.

    - rebin_every < 1: no bin states (overflow False, rebins 0).
    - ADAPTIVE (probe_fn and drift_budget > 0): the state is rebuilt before
      a render whenever probe drift from its build pose exceeds the budget
      (tested on the device at the end of each step).
    - fixed cadence: a fresh state every ``rebin_every`` steps; like the JAX
      version, the last window runs to its end and the trace is cut to
      ``chunk`` entries.

    On CUDA the step runs as a CUDA graph with the rebin as its conditional
    node (_Scan), captured at this call. combine: the sharded path's hook
    (parallel.sharding); opt_scan runs it eagerly. When set, loss_of returns
    (local_objective, local_true_loss); the step differentiates the local
    objective and combine(true_local, grad) -> (loss, grad) reduces both
    over the mesh.
    """
    scan = _Scan(dof, opt_state, opt, loss_of, bin_state_of,
                 _trace_len(chunk, rebin_every), rebin_every, combine, probe_fn, drift_budget)
    if cuda_graph.captures(dof.device) and combine is None:
        scan.capture()
    return scan.run(chunk)


def _scan_for(dof, opt_state, opt, loss_of, bin_state_of, chunk, renderer, link_poses, K,
              sharpness, rebin_every, combine=None, states=True, kernel=None):
    """The _Scan that ``calibrate`` (through _chunk_scan) and
    ``parallel.sharded_calibrate`` set up once per call and run in every
    chunk of up to ``chunk`` steps: the counterpart of the JAX package's
    jitted chunk. Each caller captures it where it can be captured: only
    on the routes with a reusable bin state (compact, dense and unfused),
    not the stateless ones (top-k binner, brute, use_pallas=False, and
    states=False). ``kernel``: the caller's _KernelStep where _kernel_route
    holds (with states), which gets the drift probes here."""
    # Renderers with reusable bin states always go through an explicit state,
    # even at rebin_every=1, so every step's overflow flag is seen.
    # rebin_every == 0 selects adaptive rebinning; a non-positive drift
    # budget makes it rebin every step instead. Other renderers (the top-k
    # binner) run stateless.
    probe_fn = None
    budget = 0.0
    if not (states and reuse_bins_ok(renderer)):
        eff = 0
    else:
        eff = max(1, rebin_every)
        if rebin_every == 0:
            budget = max(adaptive_drift_budget(renderer.tile, sharpness), 0.0)
            if budget > 0:
                probes = drift_probe_points(renderer, link_poses)
                probe_fn = make_drift_probe_fn(probes, K)
                if kernel is not None:
                    kernel.probes = probes.to(torch.float32).contiguous()
    return _Scan(dof, opt_state, opt, loss_of, bin_state_of, _trace_len(chunk, eff), eff,
                 combine, probe_fn, budget, kernel if eff else None)


def _chunk_scan(dof, opt_state, opt, link_poses, K, masks_ref, ref_tiles, renderer,
                chunk, sharpness, robust_delta, rebin_every):
    """calibrate's _Scan (_scan_for) over the mask loss, on the kernel route
    where _kernel_route holds (the frames weighted by _frame_weights),
    captured on CUDA where the renderer has reusable bin states."""

    def loss_of(d, bin_state):
        return mask_loss(d, renderer, link_poses, K, masks_ref, sharpness,
                         robust_delta, bin_state=bin_state, ref_tiles=ref_tiles)

    def bin_state_of(d):
        return renderer.bin_state(se3.exp(d), link_poses, K, sharpness=sharpness)

    kernel = None
    if _kernel_route(renderer, opt, robust_delta):
        kernel = _KernelStep(renderer, link_poses, K, ref_tiles, sharpness,
                             _frame_weights(link_poses.shape[:-3], masks_ref, robust_delta,
                                            dof.device))
    scan = _scan_for(dof, opt_state, opt, loss_of, bin_state_of, chunk, renderer,
                     link_poses, K, sharpness, rebin_every, kernel=kernel)
    if cuda_graph.captures(dof.device) and reuse_bins_ok(renderer):
        scan.capture()
    return scan


def _calibrate_scan(
    init_dof, link_poses, K, masks_ref, renderer, num_steps, max_lr,
    optimizer_name, scheduler, grad_clip, sharpness, robust_delta=0.0,
    chunk=50, rebin_every=1, resume_state=None, step_hook=None,
    on_overflow="raise", counts=None,
):
    """calibrate's loop over chunks; ``counts`` (its span's) gets
    ``kernel_steps``."""
    with span("calib.prepare"):
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
                history.append(torch.as_tensor(np.asarray(resume_state["history"]),
                                               device=dev))
        ref_tiles = tile_masks(masks_ref, renderer)
    overflowed = False
    rebins = 0
    scan = None
    while done < num_steps:
        n = min(chunk, num_steps - done)
        if scan is None:  # captured once per call, replayed in every chunk
            scan = _chunk_scan(dof, opt_state, opt, link_poses, K, masks_ref, ref_tiles,
                               renderer, n, sharpness, robust_delta, rebin_every)
        dof, opt_state, l, h, ov, nrb = scan.run(n)
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
    if counts is not None:
        counts["kernel_steps"] = scan.kernel_steps if scan is not None else 0
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

    with span("calib.call") as counts:
        allocs = device_allocs(dev)
        dof, losses, history, overflowed, rebins = _calibrate_scan(
            t(init_dof), t(link_poses), t(K), t(masks_ref), renderer,
            int(num_steps), float(max_lr), optimizer, scheduler, float(grad_clip),
            float(sharpness), float(robust_delta), rebin_every=int(rebin_every),
            resume_state=resume_state, step_hook=step_hook, on_overflow=on_overflow,
            counts=counts,
        )
        with span("calib.finish"):
            dof_np = dof.cpu().numpy()
            result = CalibResult(
                dof=dof_np,
                Tc_c2b=se3.exp(dof).cpu().numpy(),
                losses=losses.cpu().numpy(),
                history=history.cpu().numpy(),
                metrics=pose_metrics(dof_np, Tc_c2b_gt) if Tc_c2b_gt is not None else {},
                overflow=overflowed,
                rebins=rebins,
            )
        counts["rebins"] = rebins
        if allocs is not None and (now := device_allocs(dev)) is not None:
            counts["device_allocs"] = now - allocs
    return result


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
