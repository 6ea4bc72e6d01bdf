"""Shared pieces of the fused pose-gradient rasterizer, as batched torch.

Torch counterpart of the shared parts of easyhec_tpu/ops/pose_raster.py:
the record layout (``POSE_RECORD``, ``CHUNK``), ``tile_image``, and the
per-chunk math of the Pallas kernels — ``_chunk_setup`` (camera transform,
projection, validity, normalized edges, bbox), ``_chunk_coverage`` (soft
coverage) and ``_bwd_chunk`` (the analytic backward to Tc[:3,:4]).

These are the plain versions of the CUDA kernels in ``ops/csrc``: they run
the same arithmetic on whole chunk batches at once, lanes on axis -2 and
pixels on axis -1, so every chunk quantity is a [..., C] tensor and every
pixel-block quantity a [..., C, P] tensor.

The records hold base-frame corner positions Xb (packed once per rebin),
and the only per-step input is the 16-scalar camera row per frame
[Tc[:3,:4] row-major | fx fy cx cy]; zero records are empty slots (z = 0
fails z > near, so the lane is invalid).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["POSE_RECORD", "CHUNK", "tile_image"]

POSE_RECORD = 12  # [x0 y0 z0 w0 x1 y1 z1 w1 x2 y2 z2 w2]
CHUNK = 128
_EPS_Z = 1e-9
_EPS_N = 1e-12
_EDGES = ((0, 1), (1, 2), (2, 0))


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
