"""Compact-chunk-grid fused mask loss: forward and analytic backward.

Torch counterpart of easyhec_tpu/ops/pose_raster_compact.py. Records are
packed contiguously — each tile's slots start at a chunk-aligned offset,
``sum(ceil(counts/128))`` chunks in all, padded to a static budget ``nc`` —
and chunk c of frame b belongs to tile ``ctmap[b, c]``; chunks of one tile
are consecutive, padding chunks (c >= ncu[b]) continue the last real tile
with ``nlive = 0``. The backward walks its own map (``bwd_*``; equal to the
forward's unless the boundary-prefix variant shrinks it), with ``bwd_cpos``
pointing each backward chunk at its position in the shared record array.

Two CUDA kernels (``csrc/pose_raster_compact.cu``) carry this module on the
card, each with a plain PyTorch version beside it:

- ``loss_fwd_compact_cuda`` replaces ``_loss_fwd_kernel_compact``: per-tile
  raw coverage ``acc`` [B, T, th, tw] and per-tile Σ(clip(acc) − ref)² over
  the H×W crop, ``loss_tiles`` [B, T] (zero for unvisited tiles, and for
  frames with ncu == 0);
- ``loss_bwd_compact_cuda`` replaces ``_loss_bwd_kernel_compact``: the
  d(loss)/d(Tc[:3,:4]) partials per backward chunk, ``parts`` [B, ncb, 12].

A wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors; each counts its launches in
``.launches``. ``acc`` values at or above 2 are unspecified (the kernel
stops adding once a whole tile saturates); clip(acc), acc <= 1 and
0 < acc < 1 are exact.
"""
from __future__ import annotations

import torch

from . import _build
from .pose_raster import (
    _F,
    _I,
    _P,
    CHUNK,
    POSE_RECORD,
    Meta,
    _bwd_chunk,
    _chunk_coverage,
    _chunk_setup,
    _dcam,
    check_tensor,
    check_tile,
    count_launches,
    crop_mask,
    dispatch,
    i32,
    loss_cotangent,
    n_sub,
    pix_grids,
    raise_on,
    tile_origin,
)

__all__ = [
    "pose_tile_loss_compact",
    "compact_tile_acc",
    "loss_fwd_compact_cuda",
    "loss_bwd_compact_cuda",
    "loss_fwd_compact_plain",
    "loss_bwd_compact_plain",
]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _chunks_of(rec_b):
    """[12, nc*128] -> [nc, 12, 128] chunk view of one frame's records."""
    return rec_b.reshape(POSE_RECORD, -1, CHUNK).transpose(0, 1)


def loss_fwd_compact_plain(cam, rec, nlive, ctmap, ncu, ref_tiles, meta: Meta,
                           partials: bool = False):
    """Plain forward: -> (loss_tiles [B, T] (with ``partials``, [B, T, 1]),
    acc [B, T, th, tw]).

    Loops over frames so the [nc, 128, th*tw] coverage temporaries stay one
    frame large."""
    B, nc = nlive.shape
    T = ref_tiles.shape[1]
    P = meta.th * meta.tw
    dev = rec.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    acc = torch.zeros((B, T, P), dtype=torch.float32, device=dev)
    loss = torch.zeros((B, T), dtype=torch.float32, device=dev)
    tiles = torch.arange(T, device=dev)
    crop = crop_mask(tiles, meta.n_tx, meta.th, meta.tw, meta.H, meta.W)
    for b in range(B):
        ct = ctmap[b].long()
        x0, y0 = tile_origin(ct, meta.n_tx, meta.th, meta.tw)
        s = _chunk_setup(_chunks_of(rec[b]), cam[b].expand(nc, 16), x0, y0,
                         meta.near, meta.far)
        cov, *_ = _chunk_coverage(s, px, py, meta.sharpness)  # [nc, C, P]
        delta = cov.sum(dim=-2) * (nlive[b] > 0).to(torch.float32)[:, None]
        acc[b].index_add_(0, ct, delta)
        visited = torch.zeros(T, dtype=torch.bool, device=dev)
        visited[ct] = True
        e = (torch.clamp(acc[b], 0.0, 1.0) - ref_tiles[b].reshape(T, P)) * crop
        emit = visited & (ncu[b] > 0)
        loss[b] = torch.where(emit, (e * e).sum(dim=-1), torch.zeros_like(loss[b]))
    return (loss[..., None] if partials else loss), acc.reshape(B, T, meta.th, meta.tw)


def loss_bwd_compact_plain(cam, rec, bnl, bct, bcp, ref_tiles, acc, gb, meta: Meta):
    """Plain backward: -> parts [B, ncb, 12], the per-chunk d(loss)/d(Tc)
    partials (summed over the chunk's lanes)."""
    B, ncb = bnl.shape
    T = ref_tiles.shape[1]
    P = meta.th * meta.tw
    dev = rec.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    parts = torch.zeros((B, ncb, POSE_RECORD), dtype=torch.float32, device=dev)
    for b in range(B):
        ct = bct[b].long()
        blk = _chunks_of(rec[b])[bcp[b].long()]  # [ncb, 12, C]
        acc_t = acc[b].reshape(T, P)[ct]
        ref_t = ref_tiles[b].reshape(T, P)[ct]
        gp2 = loss_cotangent(acc_t, ref_t, gb[b], ct, meta)  # [ncb, P]
        live = (bnl[b] > 0) & (gp2.abs().amax(dim=-1) > 0)
        x0, y0 = tile_origin(ct, meta.n_tx, meta.th, meta.tw)
        cam_b = cam[b].expand(ncb, 16)
        s = _chunk_setup(blk, cam_b, x0, y0, meta.near, meta.far)
        upd = _bwd_chunk(s, blk, cam_b, gp2, px, py, meta.sharpness)
        parts[b] = upd.sum(dim=-1) * live.to(torch.float32)[:, None]
    return parts


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/pose_raster_compact.cu), bound with ctypes
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("pose_raster_compact")
    if not getattr(lib, "_easyhec_typed", False):
        lib.easyhec_loss_fwd_compact.argtypes = (
            [_P] * 8 + [_I] * 8 + [_F] * 3 + [_P]
        )
        lib.easyhec_loss_fwd_compact.restype = _I
        lib.easyhec_loss_bwd_compact.argtypes = (
            [_P] * 9 + [_I] * 9 + [_F] * 3 + [_I, _P]
        )
        lib.easyhec_loss_bwd_compact.restype = _I
        lib._easyhec_typed = True
    return lib


def loss_fwd_compact_cuda(cam, rec, nlive, ctmap, ncu, ref_tiles, meta: Meta,
                          partials: bool = False):
    """CUDA forward (one block per 8×32 region of a visited tile, one thread
    per pixel):
    -> (loss_tiles [B, T], acc [B, T, th, tw]); with ``partials`` the
    regions' loss partials [B, T, n_sub] unsummed."""
    dev = cam.device
    B, nc = nlive.shape
    T = ref_tiles.shape[1]
    check_tile(meta)
    check_tensor("cam", cam, torch.float32, (B, 16), dev)
    check_tensor("rec", rec, torch.float32, (B, POSE_RECORD, nc * CHUNK), dev)
    for n, t in (("nlive", nlive), ("ctmap", ctmap)):
        check_tensor(n, t, torch.int32, (B, nc), dev)
    check_tensor("ncu", ncu, torch.int32, (B,), dev)
    check_tensor("ref_tiles", ref_tiles, torch.float32, (B, T, meta.th, meta.tw), dev)
    acc = torch.zeros((B, T, meta.th, meta.tw), dtype=torch.float32, device=dev)
    loss_tiles = torch.zeros((B, T, n_sub(meta)), dtype=torch.float32, device=dev)
    err = _lib().easyhec_loss_fwd_compact(
        nlive.data_ptr(), ctmap.data_ptr(), ncu.data_ptr(), cam.data_ptr(),
        rec.data_ptr(), ref_tiles.data_ptr(), acc.data_ptr(),
        loss_tiles.data_ptr(),
        B, nc, T, meta.th, meta.tw, meta.n_tx, meta.H, meta.W,
        meta.sharpness, meta.near, meta.far,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "loss_fwd_compact kernel")
    loss_fwd_compact_cuda.launches += 1
    # per-region partials, summed in a fixed order
    return (loss_tiles if partials else loss_tiles.sum(dim=-1)), acc


def loss_bwd_compact_cuda(cam, rec, bnl, bct, bcp, ref_tiles, acc, gb, meta: Meta):
    """CUDA backward (one block per backward chunk, one thread per record
    slot):
    -> parts [B, ncb, 12]."""
    dev = cam.device
    B, ncb = bnl.shape
    nc = rec.shape[-1] // CHUNK
    T = ref_tiles.shape[1]
    check_tile(meta)
    check_tensor("cam", cam, torch.float32, (B, 16), dev)
    check_tensor("rec", rec, torch.float32, (B, POSE_RECORD, nc * CHUNK), dev)
    for n, t in (("bwd_nlive", bnl), ("bwd_ctmap", bct), ("bwd_cpos", bcp)):
        check_tensor(n, t, torch.int32, (B, ncb), dev)
    check_tensor("ref_tiles", ref_tiles, torch.float32, (B, T, meta.th, meta.tw), dev)
    check_tensor("acc", acc, torch.float32, (B, T, meta.th, meta.tw), dev)
    check_tensor("gb", gb, torch.float32, (B,), dev)
    parts = torch.empty((B, ncb, POSE_RECORD), dtype=torch.float32, device=dev)
    err = _lib().easyhec_loss_bwd_compact(
        bnl.data_ptr(), bct.data_ptr(), bcp.data_ptr(), cam.data_ptr(),
        gb.data_ptr(), rec.data_ptr(), ref_tiles.data_ptr(), acc.data_ptr(),
        parts.data_ptr(),
        B, ncb, nc, T, meta.th, meta.tw, meta.n_tx, meta.H, meta.W,
        meta.sharpness, meta.near, meta.far, int(meta.band_only),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "loss_bwd_compact kernel")
    loss_bwd_compact_cuda.launches += 1
    return parts


count_launches(loss_fwd_compact_cuda, loss_bwd_compact_cuda)


def _fwd(*args):
    return dispatch(loss_fwd_compact_cuda, loss_fwd_compact_plain, *args)


def _bwd(*args):
    return dispatch(loss_bwd_compact_cuda, loss_bwd_compact_plain, *args)


class _PoseTileLossCompact(torch.autograd.Function):
    """Per-frame loss with the analytic backward to the camera rows."""

    @staticmethod
    def forward(ctx, cam, rec, nlive, ctmap, ncu, bnl, bct, bcp, ref_tiles, meta):
        loss_tiles, acc = _fwd(cam, rec, nlive, ctmap, ncu, ref_tiles, meta)
        ctx.save_for_backward(cam, rec, bnl, bct, bcp, ref_tiles, acc)
        ctx.meta = meta
        return loss_tiles.sum(dim=-1)

    @staticmethod
    def backward(ctx, gb):
        cam, rec, bnl, bct, bcp, ref_tiles, acc = ctx.saved_tensors
        parts = _bwd(cam, rec, bnl, bct, bcp, ref_tiles, acc,
                     gb.to(torch.float32).contiguous(), ctx.meta)
        return (_dcam(parts),) + (None,) * 9


def pose_tile_loss_compact(
    cam, rec, nlive, ctmap, ncu, bwd_nlive, bwd_ctmap, bwd_cpos, ref_tiles,
    tile_h: int, tile_w: int, n_tx: int, H: int, W: int,
    sharpness: float = 1.0, near: float = 0.001, far: float = 10.0,
    band_only: bool = False,
) -> torch.Tensor:
    """Per-frame Σ (silhouette − ref)² over the tiles visited by the compact
    chunk map (the empty tiles' Σ ref² term is the caller's, see
    render.fused.loss_fused).

    cam [B, 16] (rows 0..11 = Tc[:3,:4] row-major, 12..15 = fx fy cx cy; the
    only differentiable input); rec [B, POSE_RECORD, nc*128]; nlive/ctmap
    [B, nc]; ncu [B]; bwd_* the backward's chunk map; ref_tiles
    [B, n_tiles, th, tw]. -> [B].
    """
    if rec.shape[-1] != nlive.shape[-1] * CHUNK:
        raise ValueError(
            f"rec slot axis {rec.shape[-1]} != nc*CHUNK ({nlive.shape[-1]}*{CHUNK})"
        )
    meta = Meta(int(tile_h), int(tile_w), int(n_tx), int(H), int(W),
                float(sharpness), float(near), float(far), bool(band_only))
    return _PoseTileLossCompact.apply(
        cam.to(torch.float32).contiguous(), rec.contiguous(), i32(nlive),
        i32(ctmap), i32(ncu), i32(bwd_nlive), i32(bwd_ctmap),
        i32(bwd_cpos), ref_tiles.to(torch.float32).contiguous(), meta,
    )


def compact_tile_acc(
    cam, rec, nlive, ctmap, ncu, n_tiles, tile_h, tile_w, n_tx, H, W,
    sharpness=1.0, near=0.001, far=10.0,
) -> torch.Tensor:
    """Un-clipped coverage tiles [B, n_tiles, th, tw] under the compact
    chunk map (the forward kernel run with a zero reference); unvisited
    tiles are 0."""
    meta = Meta(int(tile_h), int(tile_w), int(n_tx), int(H), int(W),
                float(sharpness), float(near), float(far))
    B = nlive.shape[0]
    zeros = torch.zeros((B, n_tiles, tile_h, tile_w), dtype=torch.float32,
                        device=rec.device)
    _, acc = _fwd(cam.detach().to(torch.float32).contiguous(), rec.contiguous(),
                  i32(nlive), i32(ctmap), i32(ncu), zeros, meta)
    return acc
