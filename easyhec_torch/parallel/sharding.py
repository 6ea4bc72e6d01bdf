"""Multi-rank sharding for calibration and rendering.

Counterpart of easyhec_tpu/parallel/sharding.py on ``torch.distributed``.
The mesh has two axes, one rank per cell:

- "data": frames (× cameras) split across ranks; each rank renders its own
  frames and the 6-dof pose gradient is summed over the mesh;
- "tile": horizontal image bands within a frame. Rendering rows
  [y0, y0 + bh) of an image equals rendering a bh-tall image with the
  principal point shifted by cy -= y0 (``_band_K``), so a band needs no
  rasterizer support of its own: the renderer is built at H = band height.

Where the JAX package runs one SPMD program under ``shard_map``, every rank
here runs the same Python: it holds the full host arrays, takes its frame
slice and row band, and meets the others in explicit collectives. The
default process group is the mesh (``make_mesh`` refuses a larger world),
and the "tile" axis has its own group.

Spans (utils.profiling): ``shard.call`` around ``sharded_calibrate``, with
counts ``rebins`` (the mesh's: each chunk's largest rank count, summed),
``own_rebins`` (this rank's), ``collectives`` (those this rank issued on
the mesh: the step's, once a step, and each chunk's flags), ``overflow``
and ``kernel_steps`` (the steps run on models/calib.py's kernel route); below it ``shard.prepare`` (this rank's slice of the host
arrays on the device, the optimizer, the tiled masks) and, per chunk, the
scan's ``calib.chunk.*`` spans, then ``shard.flags`` (the flags' max-reduce
over the mesh and its host read). When a torch profiler records the
capture, the step graph also times ``shard.combine`` on the device, the
combine's all-reduce with the wait for the slowest rank, read after each
chunk's flags.
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import se3
from ..render.renderer import RobotRenderer
from ..solver.optim import make_optimizer
from ..utils import cuda_graph
from ..utils.profiling import DeviceSpans, span
from . import comm

__all__ = [
    "make_mesh",
    "pad_frames",
    "sharded_mask_loss",
    "sharded_calibrate",
    "sharded_silhouette",
]


class _LocalMesh:
    """The (1, 1) mesh of a process without a process group: its collectives
    are identities. Answers the DeviceMesh calls this module makes."""

    mesh_dim_names = ("data", "tile")
    shape = (1, 1)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_coordinate(self) -> list[int]:
        return [0, 0]


def make_mesh(n_data: int, n_tile: int = 1, devices=None):
    """A ("data", "tile") DeviceMesh over the first n_data·n_tile of
    ``devices`` (global ranks; None: 0..world−1), laid out row-major: the
    i-th at (i // n_tile, i % n_tile). Without a process group only (1, 1)
    is possible, and its collectives are identities. Raises ValueError when
    fewer ranks are given than the mesh needs, and also when the world is
    larger than the mesh (the JAX package takes the first devices; here
    every rank must hold a cell)."""
    need = n_data * n_tile
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    for have in (len(ranks), world):
        if have < need:
            raise ValueError(f"need {need} devices, have {have}")
    if world > need:
        raise ValueError(f"mesh of {need} ranks in a world of {world}: every rank "
                         "must hold a cell of the mesh")
    ranks = ranks[:need]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices {ranks} are not the ranks 0..{world - 1}, each once")
    if not dist.is_initialized():
        return _LocalMesh()
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n_data, n_tile),
                      mesh_dim_names=("data", "tile"))


class _Layout(NamedTuple):
    n_data: int
    n_tile: int
    di: int  # this rank's data index
    ti: int  # this rank's tile (band) index
    tile_group: object  # the "tile" axis' group (None when n_tile == 1)


def _layout(mesh) -> _Layout:
    # the rank's place in the mesh tensor (get_local_rank is its rank in the
    # axis' group, whose members torch sorts: not the place when devices
    # reorder the ranks)
    n_data, n_tile = mesh.size(0), mesh.size(1)
    di, ti = mesh.get_coordinate()
    return _Layout(n_data, n_tile, di, ti, mesh.get_group("tile") if n_tile > 1 else None)


def _all_reduce(t: torch.Tensor, n: int, group=None, op=dist.ReduceOp.SUM):
    """In-place all-reduce over a group of n ranks (None: the whole mesh)."""
    if n > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


class _Replicate(torch.autograd.Function):
    """Identity forward on a replicated input; backward sums its gradient
    over the mesh (the conjugate of _MeshSum)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.n), None


class _MeshSum(torch.autograd.Function):
    """All-reduce (sum) over the mesh forward; identity backward: every rank
    already back-propagates the same global loss."""

    @staticmethod
    def forward(ctx, x, n):
        return _all_reduce(x.clone(), n)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def pad_frames(arr: np.ndarray, n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the frame axis to a multiple of n_shards. Returns (padded, weight)
    with weight 1 for real frames, 0 for padding."""
    b = arr.shape[0]
    pad = (-b) % n_shards
    w = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    return arr, w


def _band_K(K: torch.Tensor, y0: float) -> torch.Tensor:
    """Shift the principal point so a band render covers rows [y0, y0+bh)."""
    Kb = K.clone()
    Kb[1, 2] -= y0
    return Kb


def _frame_slice(lay: _Layout, B: int) -> slice:
    if B % lay.n_data:
        raise ValueError(f"{B} frames do not split over {lay.n_data} data ranks "
                         "(pad_frames)")
    b = B // lay.n_data
    return slice(lay.di * b, (lay.di + 1) * b)


def sharded_silhouette(renderer: RobotRenderer, mesh, band_h: int):
    """Build a sharded render fn: (Tc_c2b, link_poses[B,L,4,4], K) -> [B,H,W]
    with frames over "data" and image bands over "tile"; every rank returns
    the whole image batch (forward only: sharded_mask_loss carries the
    gradient).

    `renderer` must be built with H = band_h (each rank renders one band);
    the full image height is band_h * n_tile. B must split over "data"."""

    def full(Tc_c2b, link_poses, K):
        lay = _layout(mesh)
        dev = renderer.device
        lp = torch.as_tensor(_host(link_poses), device=dev)
        sl = _frame_slice(lay, lp.shape[0])
        Kb = _band_K(torch.as_tensor(_host(K), device=dev), lay.ti * band_h)
        with torch.no_grad():
            sil = renderer.silhouette(torch.as_tensor(_host(Tc_c2b), device=dev), lp[sl], Kb)
        # gloo gathers host tensors only: the bands travel as host arrays,
        # in rank order, put in mesh order (position di * n_tile + ti)
        parts = comm.all_gather_arrays(sil.cpu().numpy())  # [P, b, band_h, W]
        if not isinstance(mesh, _LocalMesh):
            parts = parts[mesh.mesh.flatten().tolist()]
        b, W = parts.shape[1], parts.shape[-1]
        out = parts.reshape(lay.n_data, lay.n_tile, b, band_h, W).transpose(0, 2, 1, 3, 4)
        return torch.as_tensor(np.ascontiguousarray(out).reshape(-1, lay.n_tile * band_h, W),
                               device=dev)

    return full


def sharded_mask_loss(renderer: RobotRenderer, mesh, band_h: int, sharpness: float = 1.0):
    """Build the sharded loss (dof, link_poses, K, masks_ref, weight) ->
    scalar: frames over "data", bands over "tile"; per-frame SUM of squared
    error over the full image, weighted MEAN over real frames (the semantics
    of models.calib.mask_loss). Every rank passes the full (padded) arrays
    and gets the same loss; its gradient in the replicated ``dof`` is the
    true global gradient on every rank (an identity whose backward sums
    over the mesh on the input, a mesh sum whose backward is the identity
    on the output)."""

    def loss(dof, link_poses, K, masks_ref, weight):
        lay = _layout(mesh)
        n = lay.n_data * lay.n_tile
        dev = renderer.device
        lp = torch.as_tensor(_host(link_poses), device=dev)
        sl = _frame_slice(lay, lp.shape[0])
        rows = slice(lay.ti * band_h, (lay.ti + 1) * band_h)
        m = torch.as_tensor(_host(masks_ref)[sl, rows], device=dev)
        w = torch.as_tensor(_host(weight), device=dev)
        Kb = _band_K(torch.as_tensor(_host(K), device=dev), lay.ti * band_h)
        d = _Replicate.apply(dof, n)
        sil = renderer.silhouette(se3.exp(d), lp[sl], Kb, sharpness)
        per_frame = torch.sum((sil - m) ** 2, dim=(-2, -1))  # this band
        num = _MeshSum.apply(torch.sum(per_frame * w[sl]), n)
        return num / torch.sum(w)

    return loss


def sharded_calibrate(
    init_dof,
    renderer: RobotRenderer,
    mesh,
    link_poses: np.ndarray,
    K: np.ndarray,
    masks_ref: np.ndarray,
    num_steps: int = 1000,
    max_lr: float = 3e-3,
    optimizer: str = "adam",
    scheduler: str = "constant",
    sharpness: float = 1.0,
    robust_delta: float = 0.0,
    grad_clip: float = 0.0,
    rebin_every: int = 1,
    chunk: int = 50,
    frame_chunk: int = 0,
    on_overflow: str = "raise",
):
    """Multi-rank calibrate(): the same optimizer machinery as the one-rank
    path (models.calib's scan: the fused loss kernels, amortized or
    adaptive rebinning, robust delta, grad clip, chunks), with the loss and
    gradient summed over the ("data", "tile") mesh.

    masks_ref: [B, H, W] with H = band_h * n_tile (`renderer` built with
    H = band_h). Every rank passes the full host arrays. Returns (dof,
    losses, history) as tensors on the renderer's device, identical on
    every rank.

    Each rank differentiates its LOCAL objective (its frames × its band);
    the scan's combine sums [loss, gradient] in one all-reduce over the mesh
    and divides by the real frame count. On the kernel route (calibrate's
    rule; no Huber loss, no frame chunks) the grad kernel writes the local
    [loss, g] under the frames' weights, the all-reduce sums that buffer in
    place and the update kernel divides by the frame count. That is exact because the full
    loss is a sum of local terms with detached robust weights (the Huber
    slope). Per step the collectives are fixed: with robust_delta > 0 one
    all-reduce over "tile" of the detached per-frame losses, then the
    combine. Rebins are local and issue none, so ranks may rebin at
    different steps (each gates on its own probe drift). The overflow flag
    and the rebin count are reduced (max) over the mesh after each chunk,
    so every rank raises or warns together.

    frame_chunk > 0 evaluates each rank's per-frame losses in blocks of that
    many frames under torch.utils.checkpoint: backward memory drops from
    O(local frames) to O(frame_chunk) renders at the cost of recomputing
    each block's forward. Exact for the gradient; bins are rebuilt per block
    (no bin-state reuse), as under the JAX package's jax.checkpoint.

    On CUDA the chunk's step is one CUDA graph, captured once per call and
    replayed in every chunk (the JAX package's one compiled program), where
    every collective the step issues can be captured: on an NCCL group, or
    on a one-rank mesh, which issues none. A gloo group of several ranks,
    frame_chunk > 0 and, as in calibrate, a renderer without reusable bin
    states run eagerly. The flags' all-reduce stays outside the graph, once
    per chunk.

    The call's rebins and overflow are the counts of its ``shard.call``
    span (utils.profiling.spans()), identical on every rank but
    ``own_rebins``.
    """
    from torch.utils.checkpoint import checkpoint

    from ..models.calib import (BinOverflowError, _kernel_route, _KernelStep, _scan_for,
                                _trace_len, mask_loss_per_frame, reuse_bins_ok, tile_masks)

    with span("shard.call") as counts:
        lay = _layout(mesh)
        n_mesh = lay.n_data * lay.n_tile
        n_tile = lay.n_tile
        with span("shard.prepare"):
            masks = _host(masks_ref)
            H_full = masks.shape[-2]
            band_h = H_full // n_tile
            if band_h != renderer.H:
                raise ValueError(
                    f"renderer H ({renderer.H}) must equal band height "
                    f"({H_full}//{n_tile}={band_h})"
                )
            dev = renderer.device
            lp, w = pad_frames(_host(link_poses), lay.n_data)
            masks, _ = pad_frames(masks, lay.n_data)
            sl = _frame_slice(lay, masks.shape[0])
            rows = slice(lay.ti * band_h, (lay.ti + 1) * band_h)
            lp = torch.as_tensor(lp[sl], device=dev)
            m_local = torch.as_tensor(np.ascontiguousarray(masks[sl, rows]), device=dev)
            wl = torch.as_tensor(w[sl], device=dev)
            den = float(w.sum())  # every rank holds all of w: the psum over "data"
            Kb = _band_K(torch.as_tensor(_host(K), device=dev), lay.ti * band_h)
            dof = torch.as_tensor(_host(init_dof), device=dev)

            opt = make_optimizer(
                optimizer, max_lr=max_lr, total_steps=num_steps,
                scheduler=scheduler, grad_clip=grad_clip,
            )
            ref_tiles = tile_masks(m_local, renderer) if frame_chunk <= 0 else None
            kernels = frame_chunk <= 0 and _kernel_route(renderer, opt, robust_delta)
            if robust_delta > 0:
                # full-image mask area per frame (robust normalization), forward only
                area = torch.clamp(_all_reduce(torch.sum(m_local, dim=(-2, -1)), n_tile,
                                               lay.tile_group), min=1.0)
        # collectives this rank issues on the mesh: per step the combine's (and
        # the robust weights' over "tile"), per chunk the flags'
        per_step = int(n_mesh > 1) + int(robust_delta > 0 and n_tile > 1)
        collectives = int(robust_delta > 0 and n_tile > 1)
        device_spans = DeviceSpans(("shard.combine",), dev)  # traced captures

        def block(d, lp_c, m_c):
            return mask_loss_per_frame(d, renderer, lp_c, Kb, m_c, sharpness)

        def _pf(d, bin_state):
            if frame_chunk <= 0:
                return mask_loss_per_frame(d, renderer, lp, Kb, m_local, sharpness,
                                           bin_state=bin_state, ref_tiles=ref_tiles)
            bl = lp.shape[0]
            fc = min(frame_chunk, bl)
            pad = (-bl) % fc
            lp_p = torch.cat([lp, lp[:1].expand((pad,) + lp.shape[1:])]) if pad else lp
            m_p = torch.cat([m_local, m_local.new_zeros((pad,) + m_local.shape[1:])]) \
                if pad else m_local
            pf = [checkpoint(block, d, lp_p[i:i + fc], m_p[i:i + fc], use_reentrant=False)
                  for i in range(0, bl + pad, fc)]
            return torch.cat(pf)[:bl]

        def loss_of(d, bin_state):
            pf_local = _pf(d, bin_state)
            if robust_delta > 0:
                pf_full = _all_reduce(pf_local.detach().clone(), n_tile, lay.tile_group)
                norm = pf_full / area
                dlt = robust_delta
                slope = torch.where(norm <= dlt, 1.0,
                                    torch.sqrt(dlt / torch.clamp(norm, min=1e-20)))
                rho = torch.where(norm <= dlt, norm, 2.0 * torch.sqrt(norm * dlt) - dlt)
                obj = torch.sum(pf_local * wl * slope)
                true_local = torch.sum(wl * rho * area) / n_tile
            else:
                obj = torch.sum(pf_local * wl)
                true_local = obj
            return obj, true_local

        def reduce(buf):
            # [loss, g0..g5] summed over the mesh in place (the kernel route's
            # update kernel divides by den)
            with device_spans.span("shard.combine"):
                _all_reduce(buf, n_mesh)

        def combine(true_local, g):
            buf = torch.cat([true_local.detach().reshape(1), g])
            reduce(buf)
            buf = buf / den
            return buf[0], buf[1:]

        def bin_state_of(d):
            return renderer.bin_state(se3.exp(d), lp, Kb, sharpness=sharpness)

        # Bin states whenever the renderer supports them (rebin_every == 0:
        # adaptive, each rank gating on the drift of its own frames' probe
        # points); the frame-chunked path rebuilds bins inside each block. One
        # scan for every chunk, captured as calibrate's where the step's
        # collectives can be: a one-rank mesh issues none, NCCL's can, gloo's not.
        losses, history = [], []
        done = rebins = own_rebins = overflow = 0
        scan = None
        while done < num_steps:
            n = min(chunk, num_steps - done)
            if scan is None:
                kernel = (_KernelStep(renderer, lp, Kb, ref_tiles, sharpness, wl, den, reduce)
                          if kernels else None)
                scan = _scan_for(dof, opt.init(dof), opt, loss_of, bin_state_of, n, renderer, lp,
                                 Kb, sharpness, rebin_every, combine=combine,
                                 states=frame_chunk <= 0, kernel=kernel)
                if (cuda_graph.captures(dev) and frame_chunk <= 0 and reuse_bins_ok(renderer)
                        and (n_mesh == 1 or dist.get_backend() == "nccl")):
                    scan.capture()
            dof, _, l, h, ov, nrb = scan.run(n)
            losses.append(l)
            history.append(h)
            done += n
            own_rebins += nrb
            collectives += per_step * _trace_len(n, scan.rebin_every) + int(n_mesh > 1)
            # any rank's overflow truncates the summed gradient: reduce the flag
            # (and the rebin count) over the whole mesh, forward only
            with span("shard.flags"):
                flags = _all_reduce(torch.tensor([float(ov), float(nrb)], device=dev), n_mesh,
                                    op=dist.ReduceOp.MAX).tolist()
                device_spans.read()
            rebins += int(flags[1])
            overflow |= flags[0] > 0
            counts.update(rebins=rebins, own_rebins=own_rebins, collectives=collectives,
                          overflow=int(overflow), kernel_steps=scan.kernel_steps)
            if on_overflow != "ignore" and flags[0] > 0:
                msg = (
                    f"sharded calibrate: bin overflow at step ~{done} on some "
                    "shard — raise render.capacity / compact_chunks or "
                    "decimate more"
                )
                if on_overflow == "raise":
                    raise BinOverflowError(msg)
                logging.getLogger("easyhec_torch").warning(msg)
        return dof, torch.cat(losses), torch.cat(history)
