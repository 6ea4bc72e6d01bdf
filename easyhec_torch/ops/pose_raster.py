"""Fused pose-gradient rasterizer: dense (frame, tile) grid, as batched torch.

Torch counterpart of easyhec_tpu/ops/pose_raster.py. It holds

- the shared pieces of every fused pose-raster kernel: the record layout
  (``POSE_RECORD``, ``CHUNK``), ``tile_image``, ``Meta``, and the per-chunk
  math of the Pallas kernels — ``_chunk_setup`` (camera transform,
  projection, validity, normalized edges, bbox), ``_chunk_coverage`` (soft
  coverage) and ``_bwd_chunk`` (the analytic backward to Tc[:3,:4]). They
  run on whole chunk batches at once, lanes on axis -2 and pixels on axis
  -1, so every chunk quantity is a [..., C] tensor and every pixel-block
  quantity a [..., C, P] tensor;
- the dense-grid entry points ``pose_tile_loss`` and
  ``pose_tile_silhouette``, each a ``torch.autograd.Function`` over a
  kernel pair of ``csrc/pose_raster.cu``:

  - ``loss_fwd_cuda`` (K1f, replaces ``_loss_fwd_kernel``): per-tile
    Σ(clip(acc) − ref)² over the H×W crop, ``loss_tiles`` [B, T], and the
    raw coverage ``acc`` [B, T, th, tw];
  - ``loss_bwd_cuda`` (K1b, replaces ``_loss_bwd_kernel``): per-tile
    d(loss)/d(Tc[:3,:4]) partials ``parts`` [B, T, 12];
  - ``sil_fwd_cuda`` (K4f, replaces ``_fwd_kernel``): clip(acc) and acc;
  - ``sil_bwd_cuda`` (K4b, replaces ``_bwd_kernel``): the image cotangent's
    partials ``parts`` [B, T, 12].

Each CUDA wrapper has a plain PyTorch version beside it (``*_plain``),
which the dispatch takes only for CPU tensors; for CUDA tensors it launches
the kernel or raises. Each wrapper counts its launches in ``.launches``.
``acc`` values at or above 2 are unspecified (the kernels stop adding once a
whole tile saturates); clip(acc), acc <= 1 and 0 < acc < 1 are exact.

The records hold base-frame corner positions Xb (packed once per rebin),
and the only per-step input is the 16-scalar camera row per frame
[Tc[:3,:4] row-major | fx fy cx cy]; zero records are empty slots (z = 0
fails z > near, so the lane is invalid). Tile t of a frame owns record
slots [t·cap, (t+1)·cap), of which the first counts[t] are live.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "POSE_RECORD",
    "CHUNK",
    "Meta",
    "tile_image",
    "pose_tile_loss",
    "pose_tile_silhouette",
    "loss_fwd_cuda",
    "loss_bwd_cuda",
    "sil_fwd_cuda",
    "sil_bwd_cuda",
    "loss_fwd_plain",
    "loss_bwd_plain",
    "sil_fwd_plain",
    "sil_bwd_plain",
]

POSE_RECORD = 12  # [x0 y0 z0 w0 x1 y1 z1 w1 x2 y2 z2 w2]
CHUNK = 128
_EPS_Z = 1e-9
_EPS_N = 1e-12
_EDGES = ((0, 1), (1, 2), (2, 0))


class Meta(NamedTuple):
    """Static parameters of one fused pose-raster call."""

    th: int
    tw: int
    n_tx: int
    H: int
    W: int
    sharpness: float = 1.0
    near: float = 0.001
    far: float = 10.0
    band_only: bool = False


def tile_image(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """[..., H, W] -> [..., n_tiles, tile_h, tile_w] (zero-padded), the
    layout the loss kernels expect for the reference masks."""
    H, W = img.shape[-2:]
    n_ty, n_tx = -(-H // tile_h), -(-W // tile_w)
    p = F.pad(img, (0, n_tx * tile_w - W, 0, n_ty * tile_h - H))
    lead = img.shape[:-2]
    p = p.reshape(lead + (n_ty, tile_h, n_tx, tile_w)).transpose(-3, -2)
    return p.reshape(lead + (n_ty * n_tx, tile_h, tile_w))


def pix_grids(th: int, tw: int, device=None):
    """Tile-local pixel-center coordinates (px, py), each [th*tw]."""
    p = torch.arange(th * tw, device=device)
    return (p % tw).to(torch.float32) + 0.5, (p // tw).to(torch.float32) + 0.5


def tile_origin(t: torch.Tensor, n_tx: int, th: int, tw: int):
    """Pixel origin (x0, y0) of tile index t (any shape, float32)."""
    return (t % n_tx).to(torch.float32) * tw, (t // n_tx).to(torch.float32) * th


def crop_mask(t: torch.Tensor, n_tx, th, tw, H, W):
    """[..., th*tw] float validity of the pixels of tile t inside the
    cropped H×W image (tile grids cover ceil-multiples of the tile size)."""
    x0, y0 = tile_origin(t, n_tx, th, tw)
    px, py = pix_grids(th, tw, t.device)
    vy = (py - 0.5 + y0[..., None]) < H
    vx = (px - 0.5 + x0[..., None]) < W
    return (vy & vx).to(torch.float32)


def _chunk_setup(blk, cam, x0, y0, near, far):
    """Per-lane triangle setup from base-frame corner records.

    blk: [..., POSE_RECORD, C] record chunks; cam: [..., 16]; x0, y0: [...]
    tile origins. Returns a dict of [..., C] tensors: camera coords, local
    pixel coords, validity, orientation, per-edge (a, b, cst, p, q, n, inv)
    and the bbox, poisoned (lox = 1e9) on invalid lanes so their coverage is
    zero without a per-pixel mask.
    """
    t = [cam[..., i, None] for i in range(12)]
    fx, fy, cx, cy = (cam[..., i, None] for i in range(12, 16))
    x0, y0 = x0[..., None], y0[..., None]

    xc, yc, zc, u, v = [], [], [], [], []
    valid = None
    for i in range(3):
        Xb, Yb, Zb, Wb = (blk[..., 4 * i + k, :] for k in range(4))
        x = t[0] * Xb + t[1] * Yb + t[2] * Zb + t[3] * Wb
        y = t[4] * Xb + t[5] * Yb + t[6] * Zb + t[7] * Wb
        z = t[8] * Xb + t[9] * Yb + t[10] * Zb + t[11] * Wb
        ok = (z > near) & (z < far)
        valid = ok if valid is None else (valid & ok)
        eps = torch.where(z < 0, torch.full_like(z, -_EPS_Z), torch.full_like(z, _EPS_Z))
        zs = torch.where(z.abs() < _EPS_Z, eps, z)
        xc.append(x)
        yc.append(y)
        zc.append(zs)
        u.append(fx * x / zs + cx - x0)
        v.append(fy * y / zs + cy - y0)

    e01u, e01v = u[1] - u[0], v[1] - v[0]
    e02u, e02v = u[2] - u[0], v[2] - v[0]
    area2 = e01u * e02v - e01v * e02u
    valid = valid & (area2.abs() > _EPS_N)
    orient = torch.where(area2 >= 0, torch.ones_like(area2), -torch.ones_like(area2))

    edges = []
    for ia, ib in _EDGES:
        p = v[ia] - v[ib]
        q = u[ib] - u[ia]
        n = torch.clamp(torch.sqrt(p * p + q * q), min=_EPS_N)
        inv = orient / n
        a = p * inv
        b = q * inv
        cst = -(a * u[ia] + b * v[ia])
        edges.append((a, b, cst, p, q, n, inv))

    lox = torch.minimum(torch.minimum(u[0], u[1]), u[2])
    hix = torch.maximum(torch.maximum(u[0], u[1]), u[2])
    loy = torch.minimum(torch.minimum(v[0], v[1]), v[2])
    hiy = torch.maximum(torch.maximum(v[0], v[1]), v[2])
    lox = torch.where(valid, lox, torch.full_like(lox, 1e9))
    return dict(
        xc=xc, yc=yc, zc=zc, u=u, v=v, valid=valid, orient=orient,
        edges=edges, bbox=(lox, loy, hix, hiy),
    )


def _chunk_coverage(s, px, py, sharpness):
    """Coverage and distance arms of setup chunks over a pixel block.

    px, py: [P]. Returns (cov, ds, dbb, dmin), each [..., C, P]."""
    def r(x):
        return x[..., None]

    ds = [r(a) * px + r(b) * py + r(cst) for (a, b, cst, *_rest) in s["edges"]]
    lox, loy, hix, hiy = (r(x) for x in s["bbox"])
    dbb = torch.minimum(
        torch.minimum(px - lox, hix - px), torch.minimum(py - loy, hiy - py)
    )
    dmin = torch.minimum(torch.minimum(torch.minimum(ds[0], ds[1]), ds[2]), dbb)
    cov = torch.clamp(0.5 + sharpness * dmin, 0.0, 1.0)
    return cov, ds, dbb, dmin


def band_mask(s, px, py, sharpness):
    """[..., C, P] bool: the pixel centre lies in the lane's bbox dilated by
    the soft band 0.5/sharpness, on valid lanes. Outside it the lane's
    coverage is exactly 0 (cov > 0 needs every bbox distance above
    -0.5/sharpness): the pairs the forward kernels evaluate, and the ones
    their bound counts."""
    band = 0.5 / sharpness
    lox, loy, hix, hiy = (x[..., None] for x in s["bbox"])
    return (s["valid"][..., None] & (px - lox > -band) & (hix - px > -band)
            & (py - loy > -band) & (hiy - py > -band))


def _first_match_arms(cands, target):
    """Disjoint first-match masks for min/max subgradients."""
    arms, taken = [], None
    for c in cands:
        m = c == target
        if taken is not None:
            m = m & ~taken
        arms.append(m)
        taken = m if taken is None else (taken | m)
    return arms


def _bwd_chunk(s, blk, cam, gp_base, px, py, sharpness):
    """Analytic backward of record chunks: d(loss)/d(Tc) lane partials.

    s: _chunk_setup dict; blk: [..., POSE_RECORD, C]; gp_base: [..., P]
    masked loss cotangent. Returns [..., POSE_RECORD, C]: row r*4+j holds
    per-lane partials of dTc[r, j].

    Subgradients of the 4-way min and of the bbox min/max take the FIRST
    matching arm in a fixed order, as the Pallas kernel does (torch's own
    minimum/clamp backward splits ties, so this is written by hand rather
    than taken from autograd through the forward).
    """
    fx, fy = cam[..., 12, None], cam[..., 13, None]
    cov, ds, dbb, dmin = _chunk_coverage(s, px, py, sharpness)
    in_band = (cov > 0.0) & (cov < 1.0)
    gp = gp_base[..., None, :] * in_band.to(cov.dtype) * sharpness

    m0 = ds[0] <= dmin
    m1 = (ds[1] <= dmin) & ~m0
    m2 = (ds[2] <= dmin) & ~m0 & ~m1
    mb = ~m0 & ~m1 & ~m2

    def red(val):  # [..., C, P] -> [..., C]
        return torch.sum(val, dim=-1)

    dabc = []
    for m in (m0, m1, m2):
        G = gp * m.to(gp.dtype)
        dabc.append((red(G * px), red(G * py), red(G)))

    lox, loy, hix, hiy = (x[..., None] for x in s["bbox"])
    axl = (px - lox) <= dbb
    axh = ((hix - px) <= dbb) & ~axl
    ayl = ((py - loy) <= dbb) & ~axl & ~axh
    ayh = ~axl & ~axh & ~ayl
    sb = gp * mb.to(gp.dtype)
    dlox = -red(sb * axl.to(gp.dtype))
    dloy = -red(sb * ayl.to(gp.dtype))
    dhix = red(sb * axh.to(gp.dtype))
    dhiy = red(sb * ayh.to(gp.dtype))

    # --- chain: edge fields -> corner pixel coords ([..., C]) ---
    u, v = s["u"], s["v"]
    du = [torch.zeros_like(u[0]) for _ in range(3)]
    dv = [torch.zeros_like(u[0]) for _ in range(3)]
    for e, (ia, ib) in enumerate(_EDGES):
        a, b, _cst, pp, q, n, inv = s["edges"][e]
        da, db, dc = dabc[e]
        # cst = -(a*ua + b*va)
        da_t = da - dc * u[ia]
        db_t = db - dc * v[ia]
        du[ia] = du[ia] + (-a * dc)
        dv[ia] = dv[ia] + (-b * dc)
        # a = p*inv, b = q*inv, inv = orient/max(|pq|, eps)
        sdot = (da_t * pp + db_t * q) / (n * n)
        dp = inv * (da_t - sdot * pp)
        dq = inv * (db_t - sdot * q)
        # p = va - vb ; q = ub - ua
        dv[ia] = dv[ia] + dp
        dv[ib] = dv[ib] - dp
        du[ib] = du[ib] + dq
        du[ia] = du[ia] - dq

    bb = s["bbox"]
    for dlo, vals, dvs, tgt in ((dlox, u, du, bb[0]), (dloy, v, dv, bb[1]),
                                (dhix, u, du, bb[2]), (dhiy, v, dv, bb[3])):
        for k, arm in enumerate(_first_match_arms(vals, tgt)):
            dvs[k] = dvs[k] + dlo * arm.to(dlo.dtype)

    # --- chain: pixel coords -> camera coords -> dTc partials ---
    vmask = s["valid"].to(gp.dtype)
    dcomp = []
    for ci in range(3):
        izs = 1.0 / s["zc"][ci]
        dxc = du[ci] * fx * izs * vmask
        dyc = dv[ci] * fy * izs * vmask
        dzc = -(du[ci] * fx * s["xc"][ci] + dv[ci] * fy * s["yc"][ci]) * izs * izs * vmask
        dcomp.append((dxc, dyc, dzc))

    rows = []
    for r in range(3):
        for j in range(4):
            tot = None
            for ci in range(3):
                term = dcomp[ci][r] * blk[..., 4 * ci + j, :]
                tot = term if tot is None else tot + term
            rows.append(tot)
    return torch.stack(rows, dim=-2)  # [..., POSE_RECORD, C]


def loss_cotangent(acc_t, ref_t, gb_b, t, meta: Meta):
    """d(loss_b)/d(acc) of tiles t = 2·gb·e·1{acc ≤ 1}, zero outside the crop
    and, with band_only, outside the silhouette band 0 < acc < 1. [..., P]."""
    e = torch.clamp(acc_t, 0.0, 1.0) - ref_t
    g = 2.0 * gb_b * e * (acc_t <= 1.0).to(torch.float32)
    g = g * crop_mask(t, meta.n_tx, meta.th, meta.tw, meta.H, meta.W)
    if meta.band_only:
        # Non-band pixels carry only pairwise-cancelling internal-edge
        # contributions (easyhec_tpu/ops/pose_raster._masked_cotangent).
        g = g * ((acc_t > 0.0) & (acc_t < 1.0)).to(torch.float32)
    return g


def image_cotangent(acc, g, meta: Meta):
    """_masked_cotangent: the image cotangent g·1{acc ≤ 1}, and only on band
    pixels (0 < acc < 1) with band_only."""
    g = g * (acc <= 1.0).to(torch.float32)
    if meta.band_only:
        g = g * ((acc > 0.0) & (acc < 1.0)).to(torch.float32)
    return g


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the dense kernels (the CPU path, and the card's
# yardstick)
# ---------------------------------------------------------------------------


def _dense_chunks(rec_b, counts_b, cap: int):
    """The used chunks of one frame, in tile order: (blk [n, 12, 128], tile
    [n]) for the ceil(min(count, cap)/128) chunks of every tile. Only these
    are gathered: a dense [T·cap/128, 128, P] block would not fit at full
    shapes."""
    T = counts_b.shape[0]
    nct = cap // CHUNK
    used = -(-torch.clamp(counts_b.long(), 0, cap) // CHUNK)  # [T]
    sel = torch.arange(nct, device=rec_b.device)[None, :] < used[:, None]
    tile, j = sel.nonzero(as_tuple=True)
    blk = rec_b.reshape(POSE_RECORD, T, nct, CHUNK)[:, tile, j]  # [12, n, C]
    return blk.transpose(0, 1), tile


def _dense_acc(cam, rec, counts, meta: Meta):
    """Raw coverage [B, T, P] of every tile (no saturation early-out)."""
    B, T = counts.shape
    cap = rec.shape[-1] // T
    dev = rec.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    acc = torch.zeros((B, T, meta.th * meta.tw), dtype=torch.float32, device=dev)
    for b in range(B):
        blk, ct = _dense_chunks(rec[b], counts[b], cap)
        if ct.numel() == 0:
            continue
        x0, y0 = tile_origin(ct, meta.n_tx, meta.th, meta.tw)
        s = _chunk_setup(blk, cam[b].expand(ct.numel(), 16), x0, y0, meta.near,
                         meta.far)
        cov, *_ = _chunk_coverage(s, px, py, meta.sharpness)  # [n, C, P]
        acc[b].index_add_(0, ct, cov.sum(dim=-2))
    return acc


def _dense_bwd(cam, rec, counts, gp, meta: Meta):
    """Per-tile d/d(Tc) partials [B, T, 12] of a masked cotangent gp
    [B, T, P], through the hand-written first-match chain (_bwd_chunk)."""
    B, T = counts.shape
    cap = rec.shape[-1] // T
    dev = rec.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    parts = torch.zeros((B, T, POSE_RECORD), dtype=torch.float32, device=dev)
    for b in range(B):
        blk, ct = _dense_chunks(rec[b], counts[b], cap)
        if ct.numel() == 0:
            continue
        x0, y0 = tile_origin(ct, meta.n_tx, meta.th, meta.tw)
        cam_b = cam[b].expand(ct.numel(), 16)
        s = _chunk_setup(blk, cam_b, x0, y0, meta.near, meta.far)
        upd = _bwd_chunk(s, blk, cam_b, gp[b][ct], px, py, meta.sharpness)
        parts[b].index_add_(0, ct, upd.sum(dim=-1))
    return parts


def loss_fwd_plain(cam, rec, counts, ref_tiles, meta: Meta, partials: bool = False):
    """Plain K1f: -> (loss_tiles [B, T] (with ``partials``, [B, T, 1]), acc
    [B, T, th, tw])."""
    B, T = counts.shape
    acc = _dense_acc(cam, rec, counts, meta)
    crop = crop_mask(torch.arange(T, device=rec.device), meta.n_tx, meta.th,
                     meta.tw, meta.H, meta.W)
    e = (torch.clamp(acc, 0.0, 1.0) - ref_tiles.reshape(B, T, -1)) * crop
    loss = (e * e).sum(dim=-1)
    return (loss[..., None] if partials else loss), acc.reshape(ref_tiles.shape)


def loss_bwd_plain(cam, rec, counts, ref_tiles, acc, gb, meta: Meta):
    """Plain K1b: -> parts [B, T, 12]."""
    B, T = counts.shape
    t = torch.arange(T, device=rec.device)
    gp = loss_cotangent(acc.reshape(B, T, -1), ref_tiles.reshape(B, T, -1),
                        gb[:, None, None], t, meta)
    return _dense_bwd(cam, rec, counts, gp, meta)


def sil_fwd_plain(cam, rec, counts, meta: Meta):
    """Plain K4f: -> (clip(acc), acc), each [B, T, th, tw]."""
    B, T = counts.shape
    acc = _dense_acc(cam, rec, counts, meta).reshape(B, T, meta.th, meta.tw)
    return torch.clamp(acc, 0.0, 1.0), acc


def sil_bwd_plain(cam, rec, counts, acc, g, meta: Meta):
    """Plain K4b: image cotangent g [B, T, th, tw] -> parts [B, T, 12]."""
    B, T = counts.shape
    gp = image_cotangent(acc, g, meta).reshape(B, T, -1)
    return _dense_bwd(cam, rec, counts, gp, meta)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/pose_raster.cu), bound with ctypes
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("pose_raster")
    if not getattr(lib, "_easyhec_typed", False):
        lib.easyhec_pose_fwd.argtypes = [_I] + [_P] * 7 + [_I] * 8 + [_F] * 3 + [_P]
        lib.easyhec_pose_fwd.restype = _I
        lib.easyhec_pose_bwd.argtypes = [_I] + [_P] * 8 + [_I] * 8 + [_F] * 3 + [_I, _P]
        lib.easyhec_pose_bwd.restype = _I
        lib._easyhec_typed = True
    return lib


def check_tensor(name, t, dtype, shape, dev):
    """Raise unless t is a contiguous ``dtype`` tensor of ``shape`` on dev."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


REGION_H, REGION_W = 8, 32  # a forward block's pixels: csrc/pose_raster_fwd.cuh


def n_sub(meta: Meta) -> int:
    """Pixel regions per tile of the forward kernels (fwd_blocks in
    csrc/pose_raster_fwd.cuh): one block of one thread per pixel owns each
    REGION_H×REGION_W region, clipped to the tile, and writes its own loss
    partial."""
    return (-(-meta.th // REGION_H)) * (-(-meta.tw // REGION_W))


def check_tile(meta: Meta):
    """Raise unless the tile has pixels."""
    if meta.th <= 0 or meta.tw <= 0:
        raise ValueError(f"empty tile {meta.th}x{meta.tw}")


def raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def _check_dense(cam, rec, counts, meta: Meta):
    """Validate the shared inputs; -> (B, T, cap, device)."""
    dev = cam.device
    B, T = counts.shape
    cap = rec.shape[-1] // T
    check_tile(meta)
    check_tensor("cam", cam, torch.float32, (B, 16), dev)
    check_tensor("rec", rec, torch.float32, (B, POSE_RECORD, T * cap), dev)
    check_tensor("counts", counts, torch.int32, (B, T), dev)
    if cap <= 0 or cap % CHUNK:
        raise ValueError(f"record capacity {cap} per tile is not a positive "
                         f"multiple of {CHUNK}")
    return B, T, cap, dev


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    """Device pointer of t, or NULL for an input or output the mode skips."""
    return None if t is None else t.data_ptr()


def _fwd_launch(loss_mode, cam, rec, counts, ref_tiles, meta: Meta, partials=False):
    B, T, cap, dev = _check_dense(cam, rec, counts, meta)
    shape = (B, T, meta.th, meta.tw)
    acc = torch.empty(shape, dtype=torch.float32, device=dev)
    if loss_mode:
        check_tensor("ref_tiles", ref_tiles, torch.float32, shape, dev)
        sil = None
        loss_tiles = torch.empty((B, T, n_sub(meta)), dtype=torch.float32, device=dev)
    else:
        sil = torch.empty(shape, dtype=torch.float32, device=dev)
        loss_tiles = None
    err = _lib().easyhec_pose_fwd(
        int(loss_mode), counts.data_ptr(), cam.data_ptr(), rec.data_ptr(),
        _ptr(ref_tiles), acc.data_ptr(), _ptr(sil), _ptr(loss_tiles),
        B, T, cap, meta.th, meta.tw, meta.n_tx, meta.H, meta.W,
        meta.sharpness, meta.near, meta.far, _stream(dev),
    )
    raise_on(err, "pose_fwd kernel")
    if not loss_mode:
        return sil, acc
    # per-region partials, summed in a fixed order
    return (loss_tiles if partials else loss_tiles.sum(dim=-1)), acc


def _bwd_launch(loss_mode, cam, rec, counts, acc, ref_tiles, gb, g, meta: Meta):
    B, T, cap, dev = _check_dense(cam, rec, counts, meta)
    shape = (B, T, meta.th, meta.tw)
    check_tensor("acc", acc, torch.float32, shape, dev)
    if loss_mode:
        check_tensor("ref_tiles", ref_tiles, torch.float32, shape, dev)
        check_tensor("gb", gb, torch.float32, (B,), dev)
    else:
        check_tensor("g", g, torch.float32, shape, dev)
    parts = torch.empty((B, T, POSE_RECORD), dtype=torch.float32, device=dev)
    err = _lib().easyhec_pose_bwd(
        int(loss_mode), counts.data_ptr(), cam.data_ptr(), rec.data_ptr(),
        acc.data_ptr(), _ptr(ref_tiles), _ptr(gb), _ptr(g), parts.data_ptr(),
        B, T, cap, meta.th, meta.tw, meta.n_tx, meta.H, meta.W,
        meta.sharpness, meta.near, meta.far, int(meta.band_only), _stream(dev),
    )
    raise_on(err, "pose_bwd kernel")
    return parts


def loss_fwd_cuda(cam, rec, counts, ref_tiles, meta: Meta, partials: bool = False):
    """K1f (one block per 8×32 region of a tile, one thread per pixel):
    -> (loss_tiles [B, T], acc [B, T, th, tw]); with ``partials`` the
    regions' loss partials [B, T, n_sub] unsummed."""
    out = _fwd_launch(True, cam, rec, counts, ref_tiles, meta, partials)
    loss_fwd_cuda.launches += 1
    return out


def loss_bwd_cuda(cam, rec, counts, ref_tiles, acc, gb, meta: Meta):
    """K1b (one block per tile, one thread per record slot):
    -> parts [B, T, 12]."""
    parts = _bwd_launch(True, cam, rec, counts, acc, ref_tiles, gb, None, meta)
    loss_bwd_cuda.launches += 1
    return parts


def sil_fwd_cuda(cam, rec, counts, meta: Meta):
    """K4f: -> (clip(acc), acc), each [B, T, th, tw]."""
    out = _fwd_launch(False, cam, rec, counts, None, meta)
    sil_fwd_cuda.launches += 1
    return out


def sil_bwd_cuda(cam, rec, counts, acc, g, meta: Meta):
    """K4b (as K1b): image cotangent g [B, T, th, tw] -> parts [B, T, 12]."""
    parts = _bwd_launch(False, cam, rec, counts, acc, None, None, g, meta)
    sil_bwd_cuda.launches += 1
    return parts


COUNTED = []  # every kernel wrapper of ops/, each counting its launches in .launches


def count_launches(*wrappers):
    """Give each kernel wrapper its launch counter (``.launches``, which the
    wrapper raises by one where it launches its kernel) and list it in
    COUNTED, whose counters a CUDA graph's replays advance
    (utils.cuda_graph.Counters)."""
    for fn in wrappers:
        fn.launches = 0
        COUNTED.append(fn)


count_launches(loss_fwd_cuda, loss_bwd_cuda, sil_fwd_cuda, sil_bwd_cuda)


def dispatch(cuda_fn, plain_fn, *args, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = args[0].device
    if dev.type == "cuda":
        return cuda_fn(*args, **kw)
    if dev.type == "cpu":
        return plain_fn(*args, **kw)
    raise ValueError(f"no pose-raster kernel for device {dev}")


def _dcam(parts):
    """[B, T, 12] per-tile partials -> [B, 16] cam cotangent (summed over
    tiles in a fixed order; the intrinsics fx fy cx cy are constants)."""
    dcam = parts.sum(dim=1)
    return torch.cat([dcam, torch.zeros_like(dcam[:, :4])], dim=-1)


class _PoseTileLoss(torch.autograd.Function):
    """Per-frame loss with the analytic backward to the camera rows."""

    @staticmethod
    def forward(ctx, cam, rec, counts, ref_tiles, meta):
        loss_tiles, acc = dispatch(loss_fwd_cuda, loss_fwd_plain, cam, rec, counts,
                                   ref_tiles, meta)
        ctx.save_for_backward(cam, rec, counts, ref_tiles, acc)
        ctx.meta = meta
        return loss_tiles.sum(dim=-1)

    @staticmethod
    def backward(ctx, gb):
        cam, rec, counts, ref_tiles, acc = ctx.saved_tensors
        parts = dispatch(loss_bwd_cuda, loss_bwd_plain, cam, rec, counts, ref_tiles,
                         acc, gb.to(torch.float32).contiguous(), ctx.meta)
        return (_dcam(parts),) + (None,) * 4


class _PoseTileSilhouette(torch.autograd.Function):
    """Clipped coverage tiles with the analytic backward to the camera rows."""

    @staticmethod
    def forward(ctx, cam, rec, counts, meta):
        sil, acc = dispatch(sil_fwd_cuda, sil_fwd_plain, cam, rec, counts, meta)
        ctx.save_for_backward(cam, rec, counts, acc)
        ctx.meta = meta
        return sil

    @staticmethod
    def backward(ctx, g):
        cam, rec, counts, acc = ctx.saved_tensors
        parts = dispatch(sil_bwd_cuda, sil_bwd_plain, cam, rec, counts, acc,
                         g.to(torch.float32).contiguous(), ctx.meta)
        return (_dcam(parts),) + (None,) * 3


def i32(t):
    return t.to(torch.int32).contiguous()


def _pad_records(rec, counts):
    """Check the record axis against n_tiles and pad each tile's slots with
    empty records up to a CHUNK multiple (small caps: tests, tiny scenes)."""
    n_tiles = counts.shape[-1]
    cap, rem = divmod(rec.shape[-1], n_tiles)
    if cap == 0 or rem != 0:
        raise ValueError(
            f"rec slot axis ({rec.shape[-1]}) must be a positive multiple of "
            f"n_tiles ({n_tiles}); records are [B, POSE_RECORD, n_tiles*cap]"
        )
    if cap % CHUNK:
        cap_pad = -(-cap // CHUNK) * CHUNK
        r = rec.reshape(rec.shape[:-1] + (n_tiles, cap))
        r = F.pad(r, (0, cap_pad - cap))
        rec = r.reshape(rec.shape[:-1] + (n_tiles * cap_pad,))
    return rec.to(torch.float32).contiguous()


def pose_tile_loss(
    cam, rec, counts, ref_tiles, tile_h: int, tile_w: int, n_tx: int, H: int,
    W: int, sharpness: float = 1.0, near: float = 0.001, far: float = 10.0,
    band_only: bool = False,
) -> torch.Tensor:
    """Per-frame mask loss Σ_pixels (silhouette − ref)², fused in the kernel
    (the silhouette image is never written).

    cam [B, 16] (rows 0..11 = Tc[:3,:4] row-major, 12..15 = fx fy cx cy; the
    only differentiable input); rec [B, POSE_RECORD, n_tiles*cap];
    counts [B, n_tiles]; ref_tiles [B, n_tiles, tile_h, tile_w] (tile_image
    of the masks). -> [B]. Every tile contributes, unvisited ones Σ ref²
    over the crop.
    """
    rec = _pad_records(rec, counts)
    meta = Meta(int(tile_h), int(tile_w), int(n_tx), int(H), int(W),
                float(sharpness), float(near), float(far), bool(band_only))
    return _PoseTileLoss.apply(cam.to(torch.float32).contiguous(), rec, i32(counts),
                               ref_tiles.to(torch.float32).contiguous(), meta)


def pose_tile_silhouette(
    cam, rec, counts, tile_h: int, tile_w: int, n_tx: int,
    sharpness: float = 1.0, near: float = 0.001, far: float = 10.0,
    band_only: bool = False,
) -> torch.Tensor:
    """Rasterize base-frame corner records under per-frame camera poses.

    cam [B, 16] (the only differentiable input); rec [B, POSE_RECORD,
    n_tiles*cap]; counts [B, n_tiles] int. -> [B, n_tiles, tile_h, tile_w]
    soft coverage in [0, 1], with the analytic backward to cam (through the
    band pixels only when band_only).
    """
    rec = _pad_records(rec, counts)
    meta = Meta(int(tile_h), int(tile_w), int(n_tx), 0, 0, float(sharpness),
                float(near), float(far), bool(band_only))
    return _PoseTileSilhouette.apply(cam.to(torch.float32).contiguous(), rec,
                                     i32(counts), meta)
