"""Tiled rasterizer: tile configuration, the unfused silhouette and depth.

Torch counterpart of easyhec_tpu/render/tiled.py:

- ``TileConfig`` (same fields and defaults, so a configuration moves between
  the packages unchanged), ``_untile`` and ``_topk_compact``;
- ``_edge_fields_soa``, the per-triangle edge/bbox setup of the unfused
  silhouette, and ``silhouette_tiled`` on the Pallas routes: the counting
  binner (``binner="count"``, binning.silhouette_counted) and the top-k
  binner (``_bin_bboxes`` + ``_pack_records``), both rasterized by K5
  (ops/tile_raster.py); and the plain-tensor route (``use_pallas=False``,
  ``_silhouette_tiled_single``, the JAX package's pure-XLA rasterizer): per
  frame, top-k bins, tile-local edges and the coverage sum in plain PyTorch
  (no kernel; 128-record chunks past a capacity of 256);
- ``depth_tiled``: hard depth and triangle ids through top-k bins, in plain
  PyTorch (in the JAX package it is XLA, not a Pallas kernel).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .projection import Triangles2D, TrianglesSoA, soa_from_aos, to_aos
from .raster_core import bbox_distance, build_edges, clip01, eval_lines, pixel_grid

__all__ = ["TileConfig", "silhouette_tiled", "depth_tiled", "bin_triangles"]


class TileConfig(NamedTuple):
    """Rasterizer tiling and binning budgets (see easyhec_tpu's TileConfig
    for the long-form notes on each field): the fused compact-chunk and
    dense routes (``fused=True``) and the unfused route (``fused=False``,
    K5) on the kernel binners, and the plain-tensor route
    (``use_pallas=False``), which the user asks for by name."""

    tile_h: int = 8
    tile_w: int = 128
    capacity: int = 256  # max triangles per tile bin
    use_pallas: bool = True  # False: the plain-tensor rasterizer, no kernel
    binner: str = "count"  # "count" (binning.bin_count) | "topk" (_bin_bboxes)
    rect_y: int = 0  # static tile-rect enumeration window; 0 = auto
    rect_x: int = 0
    margin: float = 1.0  # bbox dilation (px): soft band + rebin drift budget
    cull_backfaces: bool = False  # exact for closed oriented meshes
    fused: bool = False  # fused-pose loss kernel (render/fused.py)
    bwd_band_only: bool = False  # backward only from band pixels (0<acc<1)
    bin_big_k: int = 0  # span-classed enumeration budget (binning.bin_count)
    bin_subsort_rows: bool = False  # row-sub-classed bins
    compact_chunks: int = 0  # >0: compact-chunk-grid loss path budget
    bwd_chunks: int = 0  # >0: boundary-prefix backward map budget


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _topk_compact(overlap: torch.Tensor, k: int, sentinel: int, values=None):
    """Compact boolean rows to ascending index lists.

    overlap: [R, N] bool. Returns (ids [R, k] int32 — the first k hits in
    ascending order, ``sentinel`` for empty slots; counts [R]; overflowed
    []). A stable sort of {index if hit else N} is the exact counterpart of
    the JAX version's top_k over negated indices. ``values`` [R, N] (ids
    ascending along each row's hits) are returned in place of the column
    indices, as the JAX version's top_k over -values selects them."""
    R, N = overlap.shape
    col = torch.arange(N, device=overlap.device).expand(R, N)
    key = torch.where(overlap, col, torch.full_like(col, N))
    srt = torch.sort(key, dim=-1, stable=True).values[:, :k]
    if srt.shape[-1] < k:
        pad = torch.full((R, k - srt.shape[-1]), N, dtype=srt.dtype, device=srt.device)
        srt = torch.cat([srt, pad], dim=-1)
    hit = srt < N
    if values is not None:
        srt = values.long().gather(-1, torch.clamp(srt, max=N - 1))
    ids = torch.where(hit, srt, torch.full_like(srt, sentinel)).to(torch.int32)
    counts = overlap.sum(dim=-1)
    return ids, torch.clamp(counts, max=k).to(torch.int32), torch.any(counts > k)


def _untile(tiles: torch.Tensor, H: int, W: int, cfg: TileConfig) -> torch.Tensor:
    """[..., n_tiles, th, tw] -> [..., H, W]."""
    n_ty, n_tx = _cdiv(H, cfg.tile_h), _cdiv(W, cfg.tile_w)
    lead = tiles.shape[:-3]
    img = (
        tiles.reshape(lead + (n_ty, n_tx, cfg.tile_h, cfg.tile_w))
        .transpose(-3, -2)
        .reshape(lead + (n_ty * cfg.tile_h, n_tx * cfg.tile_w))
    )
    return img[..., :H, :W]


def _bin_bboxes(blox, bloy, bhix, bhiy, valid, H: int, W: int, cfg: TileConfig):
    """Assign (margin-dilated) triangle bboxes [F] to tiles, in two levels
    (4×2-tile super-tiles, then tiles over their super-tile's candidates).

    Returns (tri_ids [n_tiles, cap] int32 with sentinel F for empty slots;
    counts [n_tiles] int32; overflowed [] bool — a bin exceeded its
    capacity at either level)."""
    F = valid.shape[-1]
    dev = valid.device
    n_ty, n_tx = _cdiv(H, cfg.tile_h), _cdiv(W, cfg.tile_w)
    n_tiles = n_ty * n_tx
    cap = min(cfg.capacity, F)

    def axis_overlap(n, size, lo1, hi1):
        t0 = torch.arange(n, dtype=torch.float32, device=dev) * size
        return (lo1[None, :] < t0[:, None] + size) & (hi1[None, :] > t0[:, None])

    # ---- level 1: super-tiles of 4×2 tiles -------------------------------
    SY, SX = 4, 2
    sh, sw = SY * cfg.tile_h, SX * cfg.tile_w
    n_sy, n_sx = _cdiv(H, sh), _cdiv(W, sw)
    cap1 = min(max(8 * cap, 512), F)
    oy1 = axis_overlap(n_sy, sh, bloy, bhiy)
    ox1 = axis_overlap(n_sx, sw, blox, bhix)
    overlap1 = (oy1[:, None, :] & ox1[None, :, :] & valid[None, None, :]).reshape(
        n_sy * n_sx, F)
    super_ids, _, over1 = _topk_compact(overlap1, cap1, F)  # [n_super, cap1]

    # ---- level 2: tiles over their super-tile's candidates ----------------
    bounds = torch.stack([blox, bloy, bhix, bhiy], dim=0)  # [4, F]
    sent = torch.tensor([[1e30], [1e30], [-1e30], [-1e30]], dtype=bounds.dtype, device=dev)
    bounds = torch.cat([bounds, sent], dim=1)
    cb = bounds[:, super_ids.long()].reshape(4, n_sy, n_sx, 1, 1, cap1)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)  # noqa: E731
    ty0 = (ar(n_sy) * sh).reshape(n_sy, 1, 1, 1, 1) + (ar(SY) * cfg.tile_h).reshape(1, 1, SY, 1, 1)
    tx0 = (ar(n_sx) * sw).reshape(1, n_sx, 1, 1, 1) + (ar(SX) * cfg.tile_w).reshape(1, 1, 1, SX, 1)
    overlap2 = ((cb[0] < tx0 + cfg.tile_w) & (cb[2] > tx0)
                & (cb[1] < ty0 + cfg.tile_h) & (cb[3] > ty0))  # [n_sy, n_sx, SY, SX, cap1]

    def to_tile_major(x):  # (super, intra) -> row-major tile grid, crop W/H
        return x.permute(0, 2, 1, 3, 4).reshape(
            n_sy * SY, n_sx * SX, cap1)[:n_ty, :n_tx].reshape(n_tiles, cap1)

    cand = super_ids.reshape(n_sy, n_sx, 1, 1, cap1).expand(n_sy, n_sx, SY, SX, cap1)
    tri_ids, counts, over2 = _topk_compact(to_tile_major(overlap2), cap, F,
                                           values=to_tile_major(cand))
    return tri_ids, counts, over1 | over2


def bin_triangles(tris: Triangles2D, H: int, W: int, cfg: TileConfig, margin: float = 1.0):
    """bbox-overlap tile binning of one frame's AoS triangles (_bin_bboxes),
    bboxes dilated by ``margin``."""
    lo = tris.uv.amin(dim=-2) - margin  # [F, 2] (x, y)
    hi = tris.uv.amax(dim=-2) + margin
    return _bin_bboxes(lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], tris.valid, H, W, cfg)


def _gather_tile_edges(edges, tri_ids, cfg: TileConfig, n_tx: int):
    """Per-tile triangle records with edge offsets in tile-local
    coordinates: (abc_t [n_tiles, cap, 3, 3], bbox_t [n_tiles, cap, 4],
    valid_t, x0, y0)."""
    dev = edges.abc.device
    ids = tri_ids.long()
    abc_pad = torch.cat([edges.abc, edges.abc.new_zeros((1, 3, 3))])
    bbox_pad = torch.cat([edges.bbox, edges.bbox.new_zeros((1, 4))])
    valid_pad = torch.cat([edges.valid, torch.zeros(1, dtype=torch.bool, device=dev)])
    abc_t, bbox_t, valid_t = abc_pad[ids], bbox_pad[ids], valid_pad[ids]
    t = torch.arange(ids.shape[0], dtype=torch.float32, device=dev)
    x0 = (t % n_tx) * cfg.tile_w
    y0 = torch.div(t, n_tx, rounding_mode="floor") * cfg.tile_h
    # d(p_local + (x0, y0)) = a·px + b·py + (c + a·x0 + b·y0)
    c = abc_t[..., 2] + (abc_t[..., 0] * x0[:, None, None] + abc_t[..., 1] * y0[:, None, None])
    abc_t = torch.cat([abc_t[..., :2], c[..., None]], dim=-1)
    bbox_t = bbox_t - torch.stack([x0, y0, x0, y0], dim=-1)[:, None, :]
    return abc_t, bbox_t, valid_t, x0, y0


def _edge_fields_soa(t: TrianglesSoA):
    """Edge/bbox setup in lane-vector math (the SoA twin of
    raster_core.build_edges for the silhouette path). Returns 13 [..., F]
    tensors (a0 b0 c0 a1 b1 c1 a2 b2 c2 lox loy hix hiy)."""
    u0, u1, u2 = t.u[..., 0, :], t.u[..., 1, :], t.u[..., 2, :]
    v0, v1, v2 = t.v[..., 0, :], t.v[..., 1, :], t.v[..., 2, :]
    area2 = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0)
    orient = torch.where(area2 >= 0, torch.ones_like(area2), -torch.ones_like(area2))

    def edge(ua, va, ub, vb):
        a = -(vb - va)
        b = ub - ua
        inv = orient / torch.clamp(torch.sqrt(a * a + b * b), min=1e-12)
        a = a * inv
        b = b * inv
        return a, b, -(a * ua + b * va)

    a0, b0, c0 = edge(u0, v0, u1, v1)
    a1, b1, c1 = edge(u1, v1, u2, v2)
    a2, b2, c2 = edge(u2, v2, u0, v0)
    lox = torch.minimum(torch.minimum(u0, u1), u2)
    hix = torch.maximum(torch.maximum(u0, u1), u2)
    loy = torch.minimum(torch.minimum(v0, v1), v2)
    hiy = torch.maximum(torch.maximum(v0, v1), v2)
    return a0, b0, c0, a1, b1, c1, a2, b2, c2, lox, loy, hix, hiy


def _pack_records(t: TrianglesSoA, H: int, W: int, cfg: TileConfig, margin: float = 1.0):
    """Bin one frame's triangles with the top-k binner and gather field-major
    tile-local records: (rec [n_tiles, 16, cap], counts [n_tiles], overflowed
    []). Differentiable in the triangles through the gather (its backward
    is an index_add: the top-k route has no gather-only pack)."""
    from ..ops.tile_raster import TRI_RECORD

    n_tx = _cdiv(W, cfg.tile_w)
    fl = _edge_fields_soa(t)
    lox, loy, hix, hiy = (f.detach() for f in fl[9:13])
    tri_ids, counts, overflowed = _bin_bboxes(
        lox - margin, loy - margin, hix + margin, hiy + margin, t.valid, H, W, cfg)
    # fields [13, F+1]; the sentinel column F is all-zero
    fields = torch.stack(fl, dim=0)
    fields = torch.cat([fields, fields.new_zeros((13, 1))], dim=1)
    g = fields[:, tri_ids.long()]  # [13, n_tiles, cap]
    n_tiles = tri_ids.shape[0]
    ti = torch.arange(n_tiles, dtype=torch.float32, device=fields.device)
    x0 = ((ti % n_tx) * cfg.tile_w)[:, None]
    y0 = (torch.div(ti, n_tx, rounding_mode="floor") * cfg.tile_h)[:, None]
    a0, b0, c0, a1, b1, c1, a2, b2, c2 = (g[k] for k in range(9))
    c0 = c0 + a0 * x0 + b0 * y0
    c1 = c1 + a1 * x0 + b1 * y0
    c2 = c2 + a2 * x0 + b2 * y0
    zero = torch.zeros_like(a0)
    rec = torch.stack(
        [a0, b0, c0, a1, b1, c1, a2, b2, c2, g[9] - x0, g[10] - y0, g[11] - x0, g[12] - y0]
        + [zero] * (TRI_RECORD - 13), dim=1)  # [n_tiles, 16, cap]
    return rec, counts, overflowed


def _silhouette_tiled_pallas(flat: TrianglesSoA, H: int, W: int, cfg: TileConfig,
                             sharpness: float):
    """Top-k route: [N, 3, F] SoA triangles -> ([N, H, W], overflowed).
    Binning runs per frame, K5 once over the (frame, tile) grid."""
    from ..ops.tile_raster import tile_silhouette

    packs = [_pack_records(TrianglesSoA(*(a[i] for a in flat)), H, W, cfg)
             for i in range(flat.valid.shape[0])]
    rec = torch.stack([p[0] for p in packs])
    counts = torch.stack([p[1] for p in packs])
    ov = torch.stack([p[2] for p in packs]).any()
    tiles = tile_silhouette(rec, counts, cfg.tile_h, cfg.tile_w, sharpness)
    return _untile(tiles, H, W, cfg), ov


# Records per chunk of the plain-tensor route past a capacity of 256, and
# the elements of one [tiles, P, records] temporary a block of tiles may use.
_RC = 128
_TILE_BLOCK_ELEMS = 1 << 26


def _tile_block(pix, abc, bbox, valid, sharpness: float):
    """Clipped coverage [TB, P] of a block of tiles: pix [P, 3] tile-local,
    abc [TB, cap, 3, 3], bbox [TB, cap, 4], valid [TB, cap]. Capacities up
    to 256 sum over the records in one pass; larger ones sum each 128-record
    chunk, then add the chunk sums in chunk order (the JAX package's scan
    over chunks), all chunks evaluated at once."""
    cap = valid.shape[-1]
    pad = -cap % _RC if cap > 256 else 0
    if pad:
        abc = torch.cat([abc, abc.new_zeros(abc.shape[:1] + (pad, 3, 3))], dim=1)
        bbox = torch.cat([bbox, bbox.new_zeros(bbox.shape[:1] + (pad, 4))], dim=1)
        valid = torch.cat([valid, valid.new_zeros(valid.shape[:1] + (pad,))], dim=1)
    # the three edges' [TB, P, cap] distances, min'd pairwise as in the JAX
    # package (a three-way tie splits its gradient 1/4, 1/4, 1/2 there too)
    d = [eval_lines(pix, abc[:, :, k, :]) for k in range(3)]
    dmin = torch.minimum(torch.minimum(torch.minimum(d[0], d[1]), d[2]),
                         bbox_distance(pix, bbox))
    cov = clip01(0.5 + sharpness * dmin)
    cov = torch.where(valid[:, None, :], cov, torch.zeros_like(cov))
    if cap <= 256:
        return clip01(cov.sum(dim=-1))
    parts = cov.reshape(cov.shape[:2] + (-1, _RC)).sum(dim=-1)  # [TB, P, chunks]
    acc = parts[..., 0]
    for c in range(1, parts.shape[-1]):
        acc = acc + parts[..., c]
    return clip01(acc)


def _silhouette_tiled_single(tris: Triangles2D, H: int, W: int, cfg: TileConfig,
                             sharpness: float):
    """One frame's AoS triangles -> ([H, W] silhouette, overflowed []): top-k
    bins, tile-local edge records, and each block of tiles' coverage under
    torch.utils.checkpoint (recomputed in the backward instead of saving the
    [tiles, P, cap] residuals, as jax.checkpoint in the JAX package)."""
    n_ty, n_tx = _cdiv(H, cfg.tile_h), _cdiv(W, cfg.tile_w)
    edges = build_edges(tris.uv, tris.z, tris.valid)
    tri_ids, _counts, overflowed = bin_triangles(tris, H, W, cfg)
    abc_t, bbox_t, valid_t, _, _ = _gather_tile_edges(edges, tri_ids, cfg, n_tx)
    pix = pixel_grid(cfg.tile_h, cfg.tile_w, device=tris.uv.device)
    nt, cap = valid_t.shape
    tb = max(1, _TILE_BLOCK_ELEMS // (pix.shape[0] * (cap + _RC)))
    grad = torch.is_grad_enabled() and abc_t.requires_grad
    tiles = []
    for s in range(0, nt, tb):
        args = (pix, abc_t[s:s + tb], bbox_t[s:s + tb], valid_t[s:s + tb], sharpness)
        tiles.append(checkpoint(_tile_block, *args, use_reentrant=False) if grad
                     else _tile_block(*args))
    img = (torch.cat(tiles).reshape(n_ty, n_tx, cfg.tile_h, cfg.tile_w)
           .transpose(1, 2).reshape(n_ty * cfg.tile_h, n_tx * cfg.tile_w))
    return img[:H, :W], overflowed


def silhouette_tiled(
    tris,
    H: int,
    W: int,
    cfg: TileConfig = TileConfig(),
    sharpness: float = 1.0,
    return_overflow: bool = False,
):
    """Soft silhouette via tile binning. Accepts Triangles2D or TrianglesSoA
    with leading batch axes. On the kernel route all frames rasterize in one
    K5 call: the counting binner by default, ``binner="topk"`` binning per
    frame with _bin_bboxes. ``use_pallas=False`` runs the plain-tensor
    route frame by frame (_silhouette_tiled_single)."""
    batch = tris.valid.shape[:-1]
    if not cfg.use_pallas:
        aos = to_aos(tris) if isinstance(tris, TrianglesSoA) else tris
        n = math.prod(batch)
        flat = Triangles2D(*(a.reshape((n,) + a.shape[len(batch):]) for a in aos))
        out = [_silhouette_tiled_single(Triangles2D(*(a[i] for a in flat)), H, W, cfg,
                                        sharpness) for i in range(n)]
        imgs = torch.stack([o[0] for o in out]).reshape(batch + (H, W))
        ov = torch.stack([o[1] for o in out]).any()
        return (imgs, ov) if return_overflow else imgs
    soa = tris if isinstance(tris, TrianglesSoA) else soa_from_aos(tris)
    if cfg.binner == "count":
        from .binning import silhouette_counted

        imgs, ov = silhouette_counted(soa, H, W, cfg, sharpness, return_overflow=True)
    else:
        n = batch.numel()
        flat = TrianglesSoA(*(a.reshape((n,) + a.shape[len(batch):]) for a in soa))
        imgs, ov = _silhouette_tiled_pallas(flat, H, W, cfg, sharpness)
    imgs = imgs.reshape(batch + (H, W))
    return (imgs, ov) if return_overflow else imgs


# Tiles per block of the depth pass: bounds its [TB, P, cap, 3] temporaries.
_DEPTH_TILES = 8


@torch.no_grad()
def _depth_tiled_single(tris: Triangles2D, H: int, W: int, cfg: TileConfig):
    n_ty, n_tx = _cdiv(H, cfg.tile_h), _cdiv(W, cfg.tile_w)
    edges = build_edges(tris.uv, tris.z, tris.valid)
    tri_ids, _counts, overflowed = bin_triangles(tris, H, W, cfg)
    abc_t, _bbox_t, valid_t, x0, y0 = _gather_tile_edges(edges, tri_ids, cfg, n_tx)
    dev = tris.uv.device
    ids = tri_ids.long()
    bary_pad = torch.cat([edges.bary_abc, edges.bary_abc.new_zeros((1, 3, 3))])
    zinv_pad = torch.cat([edges.zinv, edges.zinv.new_ones((1, 3))])
    bary_t, zinv_t = bary_pad[ids], zinv_pad[ids]
    c = bary_t[..., 2] + (bary_t[..., 0] * x0[:, None, None] + bary_t[..., 1] * y0[:, None, None])
    bary_t = torch.cat([bary_t[..., :2], c[..., None]], dim=-1)
    pix = pixel_grid(cfg.tile_h, cfg.tile_w, device=dev)
    px, py = pix[:, 0], pix[:, 1]

    def lines(coef):  # [TB, cap, 3, 3] -> [TB, P, cap, 3]
        a, b, cc = (coef[:, None, :, :, k] for k in range(3))
        return a * px[None, :, None, None] + b * py[None, :, None, None] + cc

    zs, tids = [], []
    for s in range(0, ids.shape[0], _DEPTH_TILES):
        e = slice(s, s + _DEPTH_TILES)
        inside = torch.all(lines(abc_t[e]) >= 0.0, dim=-1) & valid_t[e][:, None, :]
        b = lines(bary_t[e])
        bsum = b.sum(dim=-1, keepdim=True)
        bary = b / torch.where(bsum.abs() < 1e-12, torch.ones_like(bsum), bsum)
        zi = (bary * zinv_t[e][:, None, :, :]).sum(dim=-1)
        z = 1.0 / torch.clamp(zi, min=1e-9)
        z_masked = torch.where(inside, z, torch.full_like(z, float("inf")))
        zmin, slot = z_masked.min(dim=-1)  # first minimum, as jnp.argmin
        hit = torch.isfinite(zmin)
        tid = torch.where(hit, ids[e].gather(1, slot), torch.full_like(slot, -1))
        zs.append(torch.where(hit, zmin, torch.zeros_like(zmin)))
        tids.append(tid.to(torch.int32))

    def untile(x):
        return (torch.cat(x).reshape(n_ty, n_tx, cfg.tile_h, cfg.tile_w)
                .transpose(1, 2).reshape(n_ty * cfg.tile_h, n_tx * cfg.tile_w)[:H, :W])

    return untile(zs), untile(tids), overflowed


def depth_tiled(tris: Triangles2D, H: int, W: int, cfg: TileConfig = TileConfig()):
    """Hard depth + triangle-id maps via tile binning (batched over leading
    axes, one frame at a time): (z [..., H, W], tri_id [..., H, W] int32,
    -1 for background)."""
    batch = tris.valid.shape[:-1]
    if not batch:
        z, tid, _ = _depth_tiled_single(tris, H, W, cfg)
        return z, tid
    n = batch.numel()
    flat = Triangles2D(*(a.reshape((n,) + a.shape[len(batch):]) for a in tris))
    out = [_depth_tiled_single(Triangles2D(*(a[i] for a in flat)), H, W, cfg)[:2]
           for i in range(n)]
    z = torch.stack([o[0] for o in out]).reshape(batch + (H, W))
    tid = torch.stack([o[1] for o in out]).reshape(batch + (H, W))
    return z, tid
