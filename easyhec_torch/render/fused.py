"""Fused-pose path: static per-rebin records, one kernel pair per step.

Torch counterpart of easyhec_tpu/render/fused.py:

- At REBIN time: project the triangles under the current pose, bin their
  margin-dilated bboxes (binning.bin_count), and pack records of BASE-frame
  corner positions Xb = T_base_from_link(qpos) @ X_rest — dense, ``cap``
  slots per tile (FusedState), or chunk-aligned and compact
  (CompactState, ``compact_chunks > 0``). Records and bins are constants
  of the rebin window.
  On the card the setup and the compact pack are the kernels of
  ops/rebin.py around the binner's (ops/binning.py).
- At STEP time: one forward and one backward kernel whose only
  differentiable input is the 16-scalar camera row per frame
  [Tc[:3,:4] | fx fy cx cy]: ops/pose_raster.py (dense: the loss K1 and the
  silhouette K4) or ops/pose_raster_compact.py (compact loss K2).
  ``loss_fused`` differentiates them with autograd, or, given a PoseGrad
  (models/calib.py's kernel route), calls them directly (``loss_parts``)
  and reduces their partials with ops/step.py's grad kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..geometry import camera
from ..ops import pose_raster as pr
from ..ops import pose_raster_compact as prc
from ..ops.pose_raster import (CHUNK, Meta, dispatch, pose_tile_loss, pose_tile_silhouette,
                               tile_image)
from ..ops.pose_raster_compact import compact_tile_acc, pose_tile_loss_compact
from ..ops.rebin import compact_pack_cuda, tri_setup_cuda
from ..ops.step import step_grad
from .binning import BinState, _rect_window, bin_count
from .projection import setup_triangles_corners
from .tiled import _cdiv, _untile

__all__ = [
    "FusedState",
    "CompactState",
    "build_fused_state",
    "build_compact_state",
    "silhouette_fused",
    "silhouette_compact",
    "loss_fused",
    "loss_parts",
    "PoseGrad",
    "tile_sq",
    "cam_rows",
    "tile_image",
]


def cam_rows(Tc_c2b: torch.Tensor, K: torch.Tensor, batch: int) -> torch.Tensor:
    """[B, 16] kernel camera rows from a pose [4, 4] or [B, 4, 4] and
    intrinsics K [3, 3]: Tc[:3,:4] row-major, then fx fy cx cy."""
    flat = Tc_c2b[..., :3, :4].reshape(Tc_c2b.shape[:-2] + (12,))
    if flat.ndim == 1:
        flat = flat.expand(batch, 12)
    kvec = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(flat.dtype)
    return torch.cat([flat, kvec.expand(batch, 4)], dim=-1)


def _base_corner_fields(corners_rest, face_link_onehot, link_poses):
    """Base-frame corner fields: list of 12 entries, [B, F] tensors at the
    x, y, z slots and None at the w slots (filled by the caller).

    corners_rest: [3, 4, F]; face_link_onehot: [L, F];
    link_poses: [B, L, 4, 4] base-from-link (FK output).
    """
    P = link_poses[..., :3, :4]  # [B, L, 3, 4]
    pr = torch.einsum("bmij,mf->bijf", P, face_link_onehot)
    rows = []
    for c in range(3):
        r = corners_rest[c]  # [4, F]
        for i in range(3):
            rows.append(
                pr[:, i, 0] * r[0] + pr[:, i, 1] * r[1]
                + pr[:, i, 2] * r[2] + pr[:, i, 3] * r[3]
            )
        rows.append(None)
    return rows


class FusedState(NamedTuple):
    """Per-rebin state of the dense fused route.

    rec:      [B, POSE_RECORD, n_tiles*cap] f32 field-major base-frame corner
              records (x,y,z,w per corner; all-zero = empty slot)
    counts:   [B, n_tiles] int32
    overflow: [B] bool — a bin of the frame exceeded cap or a bbox exceeded
              the rect enumeration window at rebin time
    """

    rec: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


class CompactState(NamedTuple):
    """Per-rebin state of the compact-chunk-grid loss path.

    rec:      [B, POSE_RECORD, nc*128] f32 compact field-major records
    nlive:    [B, nc] int32 — live slots per compact chunk
    ctmap:    [B, nc] int32 — tile of each chunk (padding chunks continue
              the last real chunk's tile with nlive 0)
    ncu:      [B] int32 — used chunks (the rest is padding)
    counts:   [B, n_tiles] int32 — per-tile loads (empty-tile loss term)
    overflow: [] bool — bin cap, rect window or the nc budget overflowed
    bwd_nlive/bwd_ctmap/bwd_cpos: the backward's chunk map (equal to the
              forward's, or the boundary-prefix subset; bwd_cpos maps each
              backward chunk to its chunk in rec)
    """

    rec: torch.Tensor
    nlive: torch.Tensor
    ctmap: torch.Tensor
    ncu: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor
    bwd_nlive: torch.Tensor
    bwd_ctmap: torch.Tensor
    bwd_cpos: torch.Tensor


def _tri_setup_plain(corners_rest, face_link_onehot, face_link_id, Tc_c2l, lp, K, margin,
                     near, far, cull_backfaces, subsort):
    """The triangle setup of a fused bin state in PyTorch (ops/rebin.py::
    tri_setup_cuda is the card's): the projection under Tc_c2l [B, L, 4, 4],
    the culls, the margin-dilated bboxes and row centres the binner takes,
    and the base-frame field table under lp [B, L, 4, 4] -> ((lox - m,
    loy - m, hix + m, hiy + m, suby or None) [B, F], valid [B, F], fpad
    [B, 12, F + 1], its last column zero). face_link_id is the kernel's."""
    tris = setup_triangles_corners(corners_rest, face_link_onehot, Tc_c2l, K, near, far,
                                   cull_backfaces=cull_backfaces)
    lox = tris.u.amin(dim=-2)
    hix = tris.u.amax(dim=-2)
    loy = tris.v.amin(dim=-2)
    hiy = tris.v.amax(dim=-2)
    suby = 0.5 * (loy + hiy) if subsort else None
    # w row = valid: 0 disables the slot via the kernel's z > near test.
    rows = _base_corner_fields(corners_rest, face_link_onehot, lp)
    vrow = tris.valid.to(torch.float32)
    fields = torch.stack([vrow if r is None else r for r in rows], dim=1)
    B = fields.shape[0]
    fpad = torch.cat([fields, fields.new_zeros((B, 12, 1))], dim=-1)
    return (lox - margin, loy - margin, hix + margin, hiy + margin, suby), tris.valid, fpad


def _fused_bins_and_fields(renderer, Tc_c2b, link_poses, K):
    """Shared rebin stage: current-pose binning + base-frame corner field
    table. Returns (BinState, fpad [B, 12, F+1], lp [B, L, 4, 4]). On the
    card the setup is one kernel (ops/rebin.py), the binner four."""
    cfg = renderer.tile
    H, W = renderer.H, renderer.W
    lp = link_poses.reshape((-1,) + link_poses.shape[-3:])
    Tc = Tc_c2b.reshape((-1, 4, 4)) if Tc_c2b.ndim > 2 else Tc_c2b
    Tc_c2l = torch.einsum(
        "ij,bljk->blik" if Tc.ndim == 2 else "bij,bljk->blik", Tc, lp
    )
    box, valid, fpad = dispatch(
        tri_setup_cuda, _tri_setup_plain, renderer.corners_rest, renderer.face_link_onehot,
        renderer.face_link_id, Tc_c2l, lp, K, cfg.margin, camera.NEAR_DEFAULT,
        camera.FAR_DEFAULT, cfg.cull_backfaces, cfg.bin_subsort_rows,
    )
    lox, loy, hix, hiy, suby = box
    ry, rx = _rect_window(H, W, cfg)
    state: BinState = bin_count(
        lox, loy, hix, hiy, valid, suby,
        H=H, W=W, tile_h=cfg.tile_h, tile_w=cfg.tile_w, cap=cfg.capacity,
        ry=ry, rx=rx, big_k=cfg.bin_big_k,
    )
    return state, fpad, lp


@torch.no_grad()
def build_fused_state(renderer, Tc_c2b, link_poses, K) -> FusedState:
    """Bin + pack dense base-frame corner records under the current pose.

    link_poses: [..., L, 4, 4]; leading batch axes are flattened."""
    state, fpad, _ = _fused_bins_and_fields(renderer, Tc_c2b, link_poses, K)
    idx = state.idx.reshape(state.idx.shape[0], -1).long()  # [B, n_tiles*cap]
    # One frame at a time: an index expanded over the 12 fields would be a
    # [B, 12, n_tiles*cap] int64 temporary (1 GB at the bench shapes).
    rec = torch.stack([fpad[b].index_select(1, idx[b]) for b in range(idx.shape[0])])
    return FusedState(rec=rec, counts=state.counts, overflow=state.overflow)


@torch.no_grad()
def build_compact_state(
    renderer,
    Tc_c2b: torch.Tensor,
    link_poses: torch.Tensor,
    K: torch.Tensor,
    nc: int | None = None,
    sharpness: float = 1.0,
) -> CompactState:
    """Bin + pack COMPACT chunk-aligned records under the current pose.

    nc: static compact-chunk budget (default renderer.tile.compact_chunks);
    overflow is flagged if sum(ceil(counts/128)) exceeds it.

    With tile.bwd_chunks > 0 and tile.bwd_band_only the backward gets its
    own boundary-prefix chunk map (budget bwd_chunks); sharpness must then
    match the loss kernel's (it sets the band width of the dilation)."""
    cfg = renderer.tile
    if nc is None:
        nc = int(cfg.compact_chunks)
    if nc <= 0:
        raise ValueError("compact_chunks must be set (> 0) for the compact path")
    state, fpad, _ = _fused_bins_and_fields(renderer, Tc_c2b, link_poses, K)
    rec, nlive, ctmap, ncu, overflow, cpos, starts = dispatch(
        compact_pack_cuda, _compact_pack_plain, state.counts, state.overflow, state.idx,
        fpad, nc,
    )
    bwd = (nlive, ctmap, cpos)
    ncb = int(cfg.bwd_chunks)
    if ncb > 0 and cfg.bwd_band_only:
        cam = cam_rows(Tc_c2b, K, nlive.shape[0])
        bwd, bwd_over = _boundary_prefix_map(
            renderer, cam, rec, nlive, ctmap, ncu, state.counts, starts, nc, ncb,
            sharpness,
        )
        overflow = overflow | bwd_over
    return CompactState(
        rec=rec,
        nlive=nlive,
        ctmap=ctmap,
        ncu=ncu,
        counts=state.counts,
        overflow=overflow,
        bwd_nlive=bwd[0],
        bwd_ctmap=bwd[1],
        bwd_cpos=bwd[2],
    )


def _compact_pack_plain(counts, bin_overflow, idx, fpad, nc):
    """The compact pack in PyTorch (ops/rebin.py::compact_pack_cuda is the
    card's): BinState counts [B, T], overflow [B] and idx [B, T, cap], the
    field table fpad [B, 12, F + 1] -> (rec [B, 12, nc*128], nlive [B, nc],
    ctmap [B, nc], ncu [B] int32, overflow [], cpos [B, nc] int32: the
    backward's identity chunk map, starts [B, T] int32: each tile's first
    chunk)."""
    counts = counts.long()  # [B, T]
    B, T = counts.shape
    cap = idx.shape[-1]
    n_faces = fpad.shape[-1] - 1  # index of the all-zero sentinel column
    dev = counts.device

    cpt = -(-counts // CHUNK)  # chunks per tile
    ends = torch.cumsum(cpt, dim=-1)
    ncu = ends[:, -1]
    overflow = torch.any(bin_overflow) | torch.any(ncu > nc)

    c0 = torch.arange(nc, device=dev)
    # tile of chunk c = first t with ends[t] > c (empty tiles are skipped)
    tile_of = torch.searchsorted(ends, c0.expand(B, nc).contiguous(), right=True)
    # Padding chunks (c >= ncu) continue the tile of the last real chunk
    # with nlive 0; all-empty frames clamp to tile T-1 and emit no loss.
    # (an over-budget ncu indexes past nc: clamp, as JAX indexing does)
    last_tile = tile_of.gather(-1, torch.clamp(ncu - 1, 0, nc - 1)[:, None])[:, 0]
    last_tile = torch.clamp(last_tile, max=T - 1)
    is_real = c0[None, :] < ncu[:, None]
    tile_of = torch.where(is_real, torch.clamp(tile_of, max=T - 1), last_tile[:, None])

    starts = ends - cpt
    koff = (c0[None, :] - starts.gather(-1, tile_of)) * CHUNK
    cnt_g = counts.gather(-1, tile_of)
    nlive = torch.where(is_real, torch.clamp(cnt_g - koff, 0, CHUNK),
                        torch.zeros_like(cnt_g))

    # Compact slot -> triangle id, through the per-tile bin lists.
    sl = koff[:, :, None] + torch.arange(CHUNK, device=dev)  # [B, nc, CH]
    ok = is_real[:, :, None] & (sl >= 0) & (sl < cap)
    gi = tile_of[:, :, None] * cap + torch.clamp(sl, 0, cap - 1)
    idxf = idx.reshape(B, -1).long()
    tri = idxf.gather(-1, gi.reshape(B, -1)).reshape(B, nc, CHUNK)
    gidx = torch.where(ok, tri, torch.full_like(tri, n_faces)).reshape(B, -1)
    rec = fpad.gather(-1, gidx[:, None, :].expand(B, 12, nc * CHUNK))

    i32 = torch.int32
    return (rec.contiguous(), nlive.to(i32), tile_of.to(i32), ncu.to(i32), overflow,
            c0.to(i32).expand(B, nc).contiguous(), starts.to(i32))


def _boundary_prefix_map(renderer, cam, rec, nlive, ctmap, ncu, counts, starts, nc,
                         ncb, sharpness):
    """The backward's own chunk map over the tiles that can hold a
    silhouette-band pixel (0 < acc < 1) anywhere in the rebin window: the
    rebin-pose band/edge region dilated by margin + band width, the same
    drift contract the binning's bbox dilation assumes. With bwd_band_only
    the other tiles carry no gradient, so the backward skips their chunks.

    counts, starts [B, T] and ncu [B]: the BinState's loads and the pack's
    chunk layout (each tile's first chunk, the chunks used). Returns
    ((bwd_nlive, bwd_ctmap, bwd_cpos) [B, ncb] int32, overflow [])."""
    cfg = renderer.tile
    H, W = renderer.H, renderer.W
    B, T = counts.shape
    dev = counts.device
    counts, starts = counts.long(), starts.long()
    cpt = torch.cat([starts[:, 1:], ncu.long()[:, None]], dim=-1) - starts  # chunks per tile
    th, tw = cfg.tile_h, cfg.tile_w
    acc = compact_tile_acc(cam, rec, nlive, ctmap, ncu, T, th, tw, _cdiv(W, tw),
                           H, W, sharpness=sharpness)
    img = _untile(acc, H, W, cfg)  # [B, H, W] un-clipped union sums
    D = int(math.ceil(cfg.margin + 0.5 / max(sharpness, 1e-6))) + 1

    def dil(m):  # max over a (2D+1)^2 window ("SAME"; the center is in it)
        return F.max_pool2d(m.to(torch.float32)[:, None], 2 * D + 1, stride=1,
                            padding=D)[:, 0]

    relevant = (dil(img > 0) > 0) & (dil(img < 1) > 0)
    band_tile = tile_image(relevant.to(torch.float32), th, tw).amax(dim=(-2, -1)) > 0

    cpt_b = torch.where(band_tile, cpt, torch.zeros_like(cpt))
    ends_b = torch.cumsum(cpt_b, dim=-1)
    ncu_b = ends_b[:, -1]
    c0b = torch.arange(ncb, device=dev)
    tob = torch.searchsorted(ends_b, c0b.expand(B, ncb).contiguous(), right=True)
    is_real = c0b[None, :] < ncu_b[:, None]
    tob = torch.where(is_real, torch.clamp(tob, max=T - 1), torch.zeros_like(tob))
    koff = c0b[None, :] - (ends_b - cpt_b).gather(-1, tob)
    cnt = counts.gather(-1, tob)
    nlive_b = torch.where(is_real, torch.clamp(cnt - koff * CHUNK, 0, CHUNK),
                          torch.zeros_like(cnt))
    fstart = starts.gather(-1, tob)
    cpos_b = torch.clamp(torch.where(is_real, fstart + koff, torch.zeros_like(koff)),
                         0, nc - 1)
    i32 = torch.int32
    return (nlive_b.to(i32), tob.to(i32), cpos_b.to(i32)), torch.any(ncu_b > ncb)


def silhouette_fused(
    renderer,
    Tc_c2b: torch.Tensor,
    link_poses: torch.Tensor,
    K: torch.Tensor,
    sharpness: float = 1.0,
    state: FusedState | None = None,
) -> torch.Tensor:
    """Soft silhouette [..., H, W] through the dense silhouette kernels (K4).

    Tc_c2b [4, 4] (or [B, 4, 4] matching the flattened frame batch);
    link_poses [..., L, 4, 4]. Differentiable in Tc_c2b only (link poses
    enter through the per-rebin records, exact for fixed qpos)."""
    cfg = renderer.tile
    H, W = renderer.H, renderer.W
    batch = link_poses.shape[:-3]
    B = math.prod(batch)
    if isinstance(state, CompactState):
        raise TypeError(
            "CompactState drives the loss path only (loss_fused); for a "
            "silhouette image pass state=None (builds a dense FusedState)"
        )
    if state is None:
        state = build_fused_state(renderer, Tc_c2b, link_poses, K)
    tiles = pose_tile_silhouette(
        cam_rows(Tc_c2b, K, B), state.rec, state.counts, cfg.tile_h, cfg.tile_w,
        _cdiv(W, cfg.tile_w), sharpness, camera.NEAR_DEFAULT, camera.FAR_DEFAULT,
        band_only=cfg.bwd_band_only,
    )
    return _untile(tiles, H, W, cfg).reshape(batch + (H, W))


@torch.no_grad()
def silhouette_compact(
    renderer,
    Tc_c2b: torch.Tensor,
    K: torch.Tensor,
    state: CompactState,
    sharpness: float = 1.0,
) -> torch.Tensor:
    """Forward-only silhouette [B, H, W] in [0, 1] from a prebuilt
    CompactState, valid for any pose within tile.margin px of the state's
    build pose (the forward kernel with a zero reference)."""
    cfg = renderer.tile
    H, W = renderer.H, renderer.W
    B, T = state.counts.shape
    cam = cam_rows(Tc_c2b, K, B)
    acc = compact_tile_acc(
        cam, state.rec, state.nlive, state.ctmap, state.ncu, T,
        cfg.tile_h, cfg.tile_w, _cdiv(W, cfg.tile_w), H, W, sharpness,
        camera.NEAR_DEFAULT, camera.FAR_DEFAULT,
    )
    return torch.clamp(_untile(acc, H, W, cfg), 0.0, 1.0)


class PoseGrad(NamedTuple):
    """loss_fused's route with no autograd (models/calib.py's kernel route):
    the frames' weights w [B], the empty tiles' Σ ref² per tile ref_sq
    [B, T] (tile_sq; compact states, else None), the camera rows cam
    [B, 16] of the pose and the Jacobian jac [12, 6] of its Tc[:3,:4] in
    the twist (both ops/step.py::step_head's), the result out [7] and
    step_grad's workspace (None on the CPU)."""

    w: torch.Tensor
    ref_sq: torch.Tensor | None
    cam: torch.Tensor
    jac: torch.Tensor
    out: torch.Tensor
    work: tuple | None


def tile_sq(ref_tiles: torch.Tensor) -> torch.Tensor:
    """[B, T] Σ ref² per tile: the loss of a tile the compact state never
    visits, constant while the reference is."""
    return torch.sum(ref_tiles * ref_tiles, dim=(-2, -1))


def loss_parts(renderer, cam: torch.Tensor, state: FusedState | CompactState,
               ref_tiles: torch.Tensor, w: torch.Tensor, sharpness: float = 1.0):
    """The fused loss kernels at the camera rows cam [B, 16], called directly
    (no autograd), ref_tiles [B, T, th, tw] float32 -> (the forward's loss
    partials [B, ...], the backward's pose partials [B, nb, 12] under the
    cotangent w [B], the compact state's counts or None). A compact
    state's frame loss adds Σ ref² over its tiles of count 0; the dense
    forward sums those itself."""
    cfg = renderer.tile
    m = Meta(cfg.tile_h, cfg.tile_w, _cdiv(renderer.W, cfg.tile_w), renderer.H, renderer.W,
             float(sharpness), camera.NEAR_DEFAULT, camera.FAR_DEFAULT, bool(cfg.bwd_band_only))
    st = state
    if isinstance(st, CompactState):
        lp, acc = dispatch(prc.loss_fwd_compact_cuda, prc.loss_fwd_compact_plain, cam, st.rec,
                           st.nlive, st.ctmap, st.ncu, ref_tiles, m, partials=True)
        parts = dispatch(prc.loss_bwd_compact_cuda, prc.loss_bwd_compact_plain, cam, st.rec,
                         st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref_tiles, acc, w, m)
        return lp, parts, st.counts
    rec, counts = pr._pad_records(st.rec, st.counts), pr.i32(st.counts)
    lp, acc = dispatch(pr.loss_fwd_cuda, pr.loss_fwd_plain, cam, rec, counts, ref_tiles, m,
                       partials=True)
    parts = dispatch(pr.loss_bwd_cuda, pr.loss_bwd_plain, cam, rec, counts, ref_tiles, acc, w, m)
    return lp, parts, None


def loss_fused(
    renderer,
    Tc_c2b: torch.Tensor,
    link_poses: torch.Tensor,
    K: torch.Tensor,
    masks_ref: torch.Tensor | None = None,
    sharpness: float = 1.0,
    state: FusedState | CompactState | None = None,
    ref_tiles: torch.Tensor | None = None,
    grad: PoseGrad | None = None,
) -> torch.Tensor:
    """Per-frame mask loss Σ_pixels (silhouette − ref)² through the fused
    loss kernels (dense K1 for a FusedState, compact K2 for a CompactState;
    state=None builds the one the tile config selects); differentiable in
    Tc_c2b only.

    Pass either masks_ref [..., H, W] or pre-tiled ref_tiles
    [..., n_tiles, th, tw] (tile_image; hoist the tiling out of optimizer
    loops). -> per-frame loss [...] matching the link_poses batch.

    With ``grad`` nothing is differentiated: the kernels run at grad.cam,
    Tc_c2b's camera rows (``loss_parts``), and ops/step.py's step_grad
    reduces their partials -> grad.out [7], the weighted loss Σ_b w_b
    loss_b and its gradient in the twist (grad.jac).
    """
    cfg = renderer.tile
    H, W = renderer.H, renderer.W
    batch = link_poses.shape[:-3]
    B = math.prod(batch)
    if state is None:
        if cfg.compact_chunks > 0:
            state = build_compact_state(renderer, Tc_c2b, link_poses, K,
                                        sharpness=sharpness)
        else:
            state = build_fused_state(renderer, Tc_c2b, link_poses, K)
    if ref_tiles is None:
        if masks_ref is None:
            raise ValueError("need masks_ref or ref_tiles")
        ref_tiles = tile_image(masks_ref.reshape((-1, H, W)), cfg.tile_h, cfg.tile_w)
    else:
        ref_tiles = ref_tiles.reshape((B,) + ref_tiles.shape[-3:])
    if grad is not None:
        lp, parts, counts = loss_parts(renderer, grad.cam, state, ref_tiles, grad.w, sharpness)
        step_grad(parts, lp, counts, grad.ref_sq, grad.w, grad.jac, grad.out, grad.work)
        return grad.out
    cam = cam_rows(Tc_c2b, K, B)
    if isinstance(state, FusedState):
        # K1f sums Σ(0 − ref)² over unvisited tiles itself: no separate term.
        return pose_tile_loss(
            cam, state.rec, state.counts, ref_tiles, cfg.tile_h, cfg.tile_w,
            _cdiv(W, cfg.tile_w), H, W, sharpness, camera.NEAR_DEFAULT,
            camera.FAR_DEFAULT, band_only=cfg.bwd_band_only,
        ).reshape(batch)
    loss_b = pose_tile_loss_compact(
        cam, state.rec, state.nlive, state.ctmap, state.ncu,
        state.bwd_nlive, state.bwd_ctmap, state.bwd_cpos, ref_tiles,
        cfg.tile_h, cfg.tile_w, _cdiv(W, cfg.tile_w), H, W, sharpness,
        camera.NEAR_DEFAULT, camera.FAR_DEFAULT, band_only=cfg.bwd_band_only,
    )
    # Tiles the compact map never visits (count == 0) render empty for any
    # pose within the binning-margin contract: their loss is the constant
    # Σ ref² per tile, added with no gradient.
    ref_sq = tile_sq(ref_tiles)  # [B, T]
    empty = torch.sum(torch.where(state.counts == 0, ref_sq, torch.zeros_like(ref_sq)),
                      dim=-1)
    return (loss_b + empty.detach()).reshape(batch)
