"""Per-tile soft-silhouette rasterization of tile-local edge records.

Torch counterpart of easyhec_tpu/ops/tile_raster.py: the rasterizer of the
unfused route (``tile.fused=False``). Triangle records are field-major per
tile,

    tri:  [B, n_tiles, 16, cap] f32
    rows: [a0 b0 c0 a1 b1 c1 a2 b2 c2 lox loy hix hiy 0 0 0]

with the edge functions already shifted into tile-local pixel coordinates
(binning.pack_records_counted), and ``counts`` [B, n_tiles] the live slots
of each tile. The kernels of ``csrc/tile_raster.cu``:

- ``tile_fwd_cuda`` (K5f, replaces ``_fwd_kernel``): clip(acc, 0, 1) and
  the raw coverage sum ``acc``, each [B, T, th, tw];
- ``tile_bwd_cuda`` (K5b, replaces ``_bwd_kernel``): d(image)/d(record)
  ``dtri`` [B, T, 16, cap], zero beyond each tile's count and in rows 13-15;
- ``tile_bwd_counted_cuda`` (K5b written through the record pack's
  transpose): ``dg`` [B, 13, T*cap_bins + 1], the shifted-back rows of each
  slot below its tile's count at ``tile*cap_bins + slot`` and the zero
  column ``T*cap_bins``; nothing else is written (the counted route's
  gather at q reads nothing else).

``tile_silhouette`` is a ``torch.autograd.Function`` over K5f and the dense
K5b (the top-k route); the counted route's Function is
``binning.counted_silhouette``. Each kernel has a plain PyTorch version
beside it (``tile_fwd_plain``, ``tile_bwd_plain``,
``tile_bwd_counted_plain``), which the dispatch takes only for CPU tensors;
for CUDA tensors it launches the kernel or raises. Each CUDA wrapper counts
its launches in ``.launches``. ``acc`` values at or above 2 are unspecified
(the forward kernel stops adding once a pixel patch saturates); clip(acc)
and the backward's acc <= 1 mask are exact.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .pose_raster import (
    _F,
    _I,
    _P,
    _stream,
    check_tensor,
    check_tile,
    count_launches,
    dispatch,
    pix_grids,
    raise_on,
)

__all__ = [
    "TRI_RECORD",
    "CHUNK",
    "TileMeta",
    "tile_silhouette",
    "tile_fwd_cuda",
    "tile_bwd_cuda",
    "tile_bwd_counted_cuda",
    "tile_fwd_plain",
    "tile_bwd_plain",
    "tile_bwd_counted_plain",
    "pad_cap",
]

TRI_RECORD = 16  # f32 rows per triangle record
CHUNK = 128  # bin slots per step
# Chunks per block of the plain versions: bounds each [n, 128, P] temporary
# to 2**23 elements.
_PLAIN_ELEMS = 1 << 23


class TileMeta(NamedTuple):
    """Static parameters of one tile-raster call."""

    th: int
    tw: int
    sharpness: float = 1.0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def _used_chunks(counts_flat, cap: int):
    """(tile, j, remaining) of every used 128-slot chunk, tile-major: the
    ceil(min(count, cap)/128) chunks of each flattened tile. Only these are
    gathered: a dense [B·T·cap/128, 128, P] block would not fit at full
    shapes."""
    nct = cap // CHUNK
    cnt = torch.clamp(counts_flat.long(), 0, cap)
    used = -(-cnt // CHUNK)
    sel = torch.arange(nct, device=cnt.device)[None, :] < used[:, None]
    tile, j = sel.nonzero(as_tuple=True)
    return tile, j, cnt[tile] - j * CHUNK


def _chunk_coverage(blk, remaining, px, py, sharpness):
    """_chunk_coverage of the Pallas kernel on chunk batches.

    blk [n, 16, C]; remaining [n] live slots from the chunk's start.
    Returns (cov, d0, d1, d2, dbb, dmin), each [n, C, P]; slots at or
    beyond ``remaining`` have zero coverage."""
    C = blk.shape[-1]

    def f(i):
        return blk[:, i, :, None]

    a0, b0, c0 = f(0), f(1), f(2)
    a1, b1, c1 = f(3), f(4), f(5)
    a2, b2, c2 = f(6), f(7), f(8)
    lox, loy, hix, hiy = f(9), f(10), f(11), f(12)
    d0 = a0 * px + b0 * py + c0
    d1 = a1 * px + b1 * py + c1
    d2 = a2 * px + b2 * py + c2
    dbb = torch.minimum(torch.minimum(px - lox, hix - px), torch.minimum(py - loy, hiy - py))
    dmin = torch.minimum(torch.minimum(torch.minimum(d0, d1), d2), dbb)
    cov = torch.clamp(0.5 + sharpness * dmin, min=0.0)
    cov = torch.clamp(cov, max=1.0)
    slot = torch.arange(C, device=blk.device)
    cov = torch.where(slot[None, :, None] < remaining[:, None, None], cov,
                      torch.zeros_like(cov))
    return cov, d0, d1, d2, dbb, dmin


def _blocks(n: int, P: int):
    step = max(1, _PLAIN_ELEMS // (CHUNK * P))
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def tile_fwd_plain(tri, counts, meta: TileMeta):
    """Plain K5f: -> (clip(acc, 0, 1), acc), each [B, T, th, tw] (no
    saturation early-out)."""
    B, T, _, cap = tri.shape
    P = meta.th * meta.tw
    dev = tri.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    flat = tri.reshape(B * T, TRI_RECORD, cap // CHUNK, CHUNK)
    tile, j, rem = _used_chunks(counts.reshape(-1), cap)
    acc = torch.zeros((B * T, P), dtype=torch.float32, device=dev)
    for s, e in _blocks(tile.numel(), P):
        blk = flat[tile[s:e], :, j[s:e]]  # [n, 16, C]
        cov, *_ = _chunk_coverage(blk, rem[s:e], px, py, meta.sharpness)
        acc.index_add_(0, tile[s:e], cov.sum(dim=1))
    acc = acc.reshape(B, T, meta.th, meta.tw)
    return torch.clamp(acc, 0.0, 1.0), acc


def tile_bwd_plain(tri, counts, acc, g, meta: TileMeta):
    """Plain K5b: image cotangent g [B, T, th, tw] -> dtri [B, T, 16, cap],
    through the hand-written first-match chain of the Pallas kernel (torch's
    own min/clamp backward would split ties)."""
    B, T, _, cap = tri.shape
    P = meta.th * meta.tw
    dev = tri.device
    s_ = meta.sharpness
    px, py = pix_grids(meta.th, meta.tw, dev)
    flat = tri.reshape(B * T, TRI_RECORD, cap // CHUNK, CHUNK)
    # d clip(acc)/d acc = 1 only below saturation (the reference's clamp)
    gp_base = (g * (acc <= 1.0).to(torch.float32)).reshape(B * T, P)
    tile, j, rem = _used_chunks(counts.reshape(-1), cap)
    dtri = torch.zeros((B * T, TRI_RECORD, cap // CHUNK, CHUNK), dtype=torch.float32,
                       device=dev)
    for s, e in _blocks(tile.numel(), P):
        ts, js = tile[s:e], j[s:e]
        blk = flat[ts, :, js]
        cov, d0, d1, d2, dbb, dmin = _chunk_coverage(blk, rem[s:e], px, py, s_)
        in_band = (cov > 0.0) & (cov < 1.0)
        gp = gp_base[ts][:, None, :] * in_band.to(torch.float32) * s_  # [n, C, P]
        # subgradient of the 4-way min: first matching arm wins
        m0 = d0 <= dmin
        m1 = (d1 <= dmin) & ~m0
        m2 = (d2 <= dmin) & ~m0 & ~m1
        mb = ~m0 & ~m1 & ~m2
        rows = []
        for m in (m0, m1, m2):
            G = gp * m.to(torch.float32)
            rows += [(G * px).sum(-1), (G * py).sum(-1), G.sum(-1)]
        lox, loy = blk[:, 9, :, None], blk[:, 10, :, None]
        hix, hiy = blk[:, 11, :, None], blk[:, 12, :, None]
        axl = (px - lox) <= dbb
        axh = ((hix - px) <= dbb) & ~axl
        ayl = ((py - loy) <= dbb) & ~axl & ~axh
        ayh = ~axl & ~axh & ~ayl
        sb = gp * mb.to(torch.float32)
        rows += [
            -(sb * axl.to(torch.float32)).sum(-1),
            -(sb * ayl.to(torch.float32)).sum(-1),
            (sb * axh.to(torch.float32)).sum(-1),
            (sb * ayh.to(torch.float32)).sum(-1),
        ]
        zero = torch.zeros_like(rows[0])
        dtri[ts, :, js] = torch.stack(rows + [zero] * (TRI_RECORD - 13), dim=1)
    return dtri.reshape(B, T, TRI_RECORD, cap)


def tile_bwd_counted_plain(tri, counts, acc, g, meta: TileMeta, n_tx: int, cap_bins: int):
    """Plain counted K5b: tile_bwd_plain's dtri cut to the bins' cap and
    shifted back by the record pack's transpose -> dg [B, 13, T*cap_bins +
    1] (binning._unshift_rows; the last column is zero). Equal to the
    kernel's output where the kernel writes, the slots below each tile's
    count; zero elsewhere."""
    from ..render.binning import _unshift_rows

    dtri = tile_bwd_plain(tri, counts, acc, g, meta)[..., :cap_bins]
    return _unshift_rows(dtri, n_tx, meta.th, meta.tw)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/tile_raster.cu), bound with ctypes
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("tile_raster")
    if not getattr(lib, "_easyhec_typed", False):
        lib.easyhec_tile_fwd.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
        lib.easyhec_tile_fwd.restype = _I
        lib.easyhec_tile_bwd.argtypes = [_I] + [_P] * 5 + [_I] * 7 + [_F, _P]
        lib.easyhec_tile_bwd.restype = _I
        lib._easyhec_typed = True
    return lib


def _check(tri, counts, meta: TileMeta):
    """Validate the shared inputs; -> (B, T, cap, device)."""
    dev = tri.device
    B, T, _, cap = tri.shape
    check_tile(meta)
    check_tensor("tri", tri, torch.float32, (B, T, TRI_RECORD, cap), dev)
    check_tensor("counts", counts, torch.int32, (B, T), dev)
    if cap <= 0 or cap % CHUNK:
        raise ValueError(f"record capacity {cap} per tile is not a positive "
                         f"multiple of {CHUNK}")
    return B, T, cap, dev


def tile_fwd_cuda(tri, counts, meta: TileMeta):
    """K5f (one resident wave of blocks walking the (tile, 8x32 region)
    items, one thread per pixel): -> (clip(acc, 0, 1), acc), each
    [B, T, th, tw]."""
    B, T, cap, dev = _check(tri, counts, meta)
    out = torch.empty((B, T, meta.th, meta.tw), dtype=torch.float32, device=dev)
    acc = torch.empty_like(out)
    err = _lib().easyhec_tile_fwd(
        counts.data_ptr(), tri.data_ptr(), out.data_ptr(), acc.data_ptr(),
        B, T, cap, meta.th, meta.tw, meta.sharpness, _stream(dev),
    )
    raise_on(err, "tile_fwd kernel")
    tile_fwd_cuda.launches += 1
    return out, acc


def _bwd_launch(counted, tri, counts, acc, g, out, meta: TileMeta, n_tx, cap_bins):
    """Launch K5b into `out`: dtri, or dg when counted."""
    B, T, cap, dev = _check(tri, counts, meta)
    shape = (B, T, meta.th, meta.tw)
    check_tensor("acc", acc, torch.float32, shape, dev)
    check_tensor("g", g, torch.float32, shape, dev)
    err = _lib().easyhec_tile_bwd(
        counted, counts.data_ptr(), tri.data_ptr(), acc.data_ptr(), g.data_ptr(),
        out.data_ptr(), B, T, cap, meta.th, meta.tw, n_tx, cap_bins, meta.sharpness,
        _stream(dev),
    )
    raise_on(err, "tile_bwd kernel")


def tile_bwd_cuda(tri, counts, acc, g, meta: TileMeta):
    """K5b, dense (one block per tile, one thread per slot): image cotangent
    g [B, T, th, tw] -> dtri [B, T, 16, cap], written everywhere."""
    dtri = torch.empty_like(tri)
    _bwd_launch(0, tri, counts, acc, g, dtri, meta, 1, tri.shape[-1])
    tile_bwd_cuda.launches += 1
    return dtri


def tile_bwd_counted_cuda(tri, counts, acc, g, meta: TileMeta, n_tx: int, cap_bins: int):
    """K5b, counted (one block per tile, one thread per slot): image
    cotangent g [B, T, th, tw] -> dg [B, 13, T*cap_bins + 1], the record
    pack's transpose of each slot below its tile's count (tiles of th x tw
    pixels, n_tx per row; cap_bins the bins' cap, at most tri's). Only
    those entries and the zero column T*cap_bins are written."""
    B, T = counts.shape
    if not 0 < cap_bins <= tri.shape[-1]:
        raise ValueError(f"bins' cap {cap_bins} outside (0, {tri.shape[-1]}]")
    dg = torch.empty((B, 13, T * cap_bins + 1), dtype=torch.float32, device=tri.device)
    dg[:, :, -1].zero_()
    _bwd_launch(1, tri, counts, acc, g, dg, meta, int(n_tx), int(cap_bins))
    tile_bwd_counted_cuda.launches += 1
    return dg


count_launches(tile_fwd_cuda, tile_bwd_cuda, tile_bwd_counted_cuda)


def pad_cap(tri):
    """tri [..., cap] with its cap padded to a multiple of 128 (empty slots)."""
    cap = tri.shape[-1]
    return F.pad(tri, (0, -(-cap // CHUNK) * CHUNK - cap)) if cap % CHUNK else tri


class _TileSilhouette(torch.autograd.Function):
    """Clipped coverage tiles with the analytic backward to the records."""

    @staticmethod
    def forward(ctx, tri, counts, meta):
        out, acc = dispatch(tile_fwd_cuda, tile_fwd_plain, tri, counts, meta)
        ctx.save_for_backward(tri, counts, acc)
        ctx.meta = meta
        return out

    @staticmethod
    def backward(ctx, g):
        tri, counts, acc = ctx.saved_tensors
        dtri = dispatch(tile_bwd_cuda, tile_bwd_plain, tri, counts, acc,
                        g.to(torch.float32).contiguous(), ctx.meta)
        return dtri, None, None


def tile_silhouette(
    tri: torch.Tensor,
    counts: torch.Tensor,
    tile_h: int,
    tile_w: int,
    sharpness: float = 1.0,
) -> torch.Tensor:
    """Rasterize per-tile triangle bins to soft coverage.

    tri: [B, n_tiles, TRI_RECORD, cap] f32 field-major tile-local records
    (slots beyond counts[b, i] are ignored); counts: [B, n_tiles] int.
    -> [B, n_tiles, tile_h, tile_w] coverage in [0, 1], differentiable with
    respect to ``tri``. A cap that is not a multiple of 128 is padded with
    empty slots, and the gradient is cropped back by the pad's backward.
    """
    tri = pad_cap(tri)
    meta = TileMeta(int(tile_h), int(tile_w), float(sharpness))
    return _TileSilhouette.apply(tri.to(torch.float32).contiguous(),
                                 counts.to(torch.int32).contiguous(), meta)
