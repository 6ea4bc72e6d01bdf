"""Counting-sort tile binning and the gather-only record pack.

Torch counterpart of easyhec_tpu/render/binning.py. The tiles
overlapped by a triangle's (margin-dilated) bbox form an axis-aligned
rectangle, so the (triangle, tile) incidence is enumerated densely as static
"rect slots" per triangle; sorting the enumerated keys then yields the
per-tile triangle lists.

The JAX version ranks entries with a counting sort whose slot is the stable
rank of an entry within its key (per-chunk histograms + a triangular
matmul). A stable ``torch.sort`` on the keys produces exactly those ranks,
so ``idx``, ``counts``, ``q`` and ``overflow`` agree bit for bit given the
same bboxes.

The unfused silhouette route (``silhouette_counted``) packs tile-local edge
records from the bins and rasterizes them with K5 in one
``torch.autograd.Function`` (``counted_silhouette``). Its backward is K5b
written through the transpose of the pack's tile-local shift, then a pure
gather at ``q`` (``dfields[f] = Σ_r dg[q[f, r]]``): autograd of the pack's
index would scatter-add, which on CUDA uses float atomics and is not
deterministic, and the gather reads only the live slots, so no dense
d(record) is ever made. ``pack_records_counted`` is the pack alone, with
the same gather-only backward.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

from .tiled import _cdiv, _edge_fields_soa, _topk_compact, _untile

__all__ = [
    "BinState",
    "bin_count",
    "pack_records_counted",
    "counted_silhouette",
    "fields_and_bins",
    "silhouette_counted",
]


class BinState(NamedTuple):
    """Integer binning state (no gradients flow through any field).

    idx:      [..., n_tiles, cap] int32 — triangle id per slot; F = sentinel
    counts:   [..., n_tiles] int32 — occupied slots per tile
    q:        [..., F, R] int32 — flat tile*cap + slot per rect entry;
              n_tiles*cap (out of range) where the entry is unused
    overflow: [...] bool — a tile exceeded cap, or a triangle's tile rect
              exceeded the static (ry, rx) enumeration window
    """

    idx: torch.Tensor
    counts: torch.Tensor
    q: torch.Tensor
    overflow: torch.Tensor


def _bin_count_flat(lox, loy, hix, hiy, valid, suby, H, W, th, tw, cap, ry, rx,
                    big_k):
    """bin_count over a flat [B, F] batch."""
    B, F = valid.shape
    dev = valid.device
    n_ty, n_tx = _cdiv(H, th), _cdiv(W, tw)
    K = n_ty * n_tx
    # suby enables row-sub-classed bins: key tile*2 + 1{bbox center in the
    # lower half of the tile} lists each bin's upper-half triangles first.
    NCLS = 1 if suby is None else 2
    SENT = K * NCLS  # key of unused entries

    def _cls(ty, sy):
        return ((sy - ty.to(torch.float32) * th) * 2.0 >= th).long()

    def ar(n):
        return torch.arange(n, device=dev)

    # ---- tile rectangles --------------------------------------------------
    on_screen = (hix > 0.0) & (lox < W) & (hiy > 0.0) & (loy < H)
    use = valid & on_screen
    ty0 = torch.clamp(torch.floor(loy / th).long(), 0, n_ty - 1)
    ty1 = torch.clamp(torch.floor(hiy / th).long(), 0, n_ty - 1)
    tx0 = torch.clamp(torch.floor(lox / tw).long(), 0, n_tx - 1)
    tx1 = torch.clamp(torch.floor(hix / tw).long(), 0, n_tx - 1)
    span_y = ty1 - ty0 + 1
    span_x = tx1 - tx0 + 1
    rect_over = torch.any(use & ((span_y > ry) | (span_x > rx)), dim=-1)

    iy = ar(ry).view(1, 1, ry, 1)
    ix = ar(rx).view(1, 1, 1, rx)
    if big_k <= 0:
        # ---- dense enumeration: ry*rx rect slots for every triangle -------
        R_out = ry * rx
        ty = ty0[..., None, None] + iy
        tx = tx0[..., None, None] + ix
        inside = (
            use[..., None, None]
            & (iy < span_y[..., None, None])
            & (ix < span_x[..., None, None])
        )
        tkey = ty * n_tx + tx
        if NCLS == 2:
            tkey = tkey * 2 + _cls(ty, suby[..., None, None])
        keys = torch.where(inside, tkey, SENT).reshape(B, F * R_out)
        fid = ar(F).repeat_interleave(R_out).expand(B, F * R_out)
        big_ids = None
    else:
        # ---- span-classed enumeration: bboxes spanning <= 2 tile rows x 1
        # column get `by` entries; only up to big_k larger ones get the full
        # ry x rx window, compacted first.
        big_k = min(big_k, F)
        by = min(2, ry)
        need_big = use & ((span_y > by) | (span_x > 1))
        rect_over = rect_over | (need_big.sum(dim=-1) > big_k)
        big_ids = _topk_compact(need_big, big_k, F)[0].long()  # [B, big_k]

        iyb = ar(by).view(1, 1, by)
        tyb = ty0[..., None] + iyb
        inside_b = use[..., None] & ~need_big[..., None] & (iyb < span_y[..., None])
        tkey_b = tyb * n_tx + tx0[..., None]
        if NCLS == 2:
            tkey_b = tkey_b * 2 + _cls(tyb, suby[..., None])
        keys_b = torch.where(inside_b, tkey_b, SENT)

        def padg(a, v):  # gather through a table padded with one `v` entry
            pad = torch.full((B, 1), v, dtype=a.dtype, device=dev)
            return torch.cat([a, pad], dim=-1).gather(-1, big_ids)

        tyg = padg(ty0, 0)[..., None, None] + iy
        txg = padg(tx0, 0)[..., None, None] + ix
        inside_g = (iy < padg(span_y, 0)[..., None, None]) & (
            ix < padg(span_x, 0)[..., None, None]
        )
        tkey_g = tyg * n_tx + txg
        if NCLS == 2:
            tkey_g = tkey_g * 2 + _cls(tyg, padg(suby, 0.0)[..., None, None])
        keys_g = torch.where(inside_g, tkey_g, SENT)
        keys = torch.cat(
            [keys_b.reshape(B, F * by), keys_g.reshape(B, big_k * ry * rx)], dim=-1
        )
        fid = torch.cat(
            [ar(F).repeat_interleave(by).expand(B, F * by),
             big_ids.repeat_interleave(ry * rx, dim=-1)],
            dim=-1,
        )
        R_out = by + ry * rx

    # ---- sort: slot = stable rank within the tile -------------------------
    srt, perm = torch.sort(keys, dim=-1, stable=True)
    totals = torch.zeros((B, SENT + 1), dtype=torch.long, device=dev)
    totals.scatter_add_(-1, keys, torch.ones_like(keys))
    tile_tot = totals[:, :SENT].reshape(B, K, NCLS).sum(dim=-1)
    tile_start = torch.cumsum(tile_tot, dim=-1) - tile_tot  # [B, K]
    tile_start = torch.cat(
        [tile_start, torch.zeros((B, 1), dtype=torch.long, device=dev)], dim=-1
    )  # sentinel key -> column K
    pos = ar(keys.shape[-1]).expand_as(srt)
    slot_sorted = pos - tile_start.gather(-1, srt // NCLS)
    slot = torch.empty_like(slot_sorted).scatter_(-1, perm, slot_sorted)

    ok = (keys < SENT) & (slot < cap)
    q = torch.where(ok, (keys // NCLS) * cap + slot, K * cap)

    # ---- invert into per-tile lists (unique positions; the dump column
    # K*cap takes every unused entry and is cut off) ------------------------
    idx = torch.full((B, K * cap + 1), F, dtype=torch.long, device=dev)
    idx.scatter_(-1, q, fid)
    idx = idx[:, : K * cap].reshape(B, K, cap)
    counts = torch.clamp(tile_tot, max=cap)
    overflow = rect_over | torch.any(tile_tot > cap, dim=-1)

    # ---- per-triangle transpose map [B, F, R_out] ---------------------------
    if big_ids is None:
        q_full = q.reshape(B, F, R_out)
    else:
        q_b = q[:, : F * by].reshape(B, F, by)
        q_g = q[:, F * by:].reshape(B, big_k, ry * rx)
        q_ext = torch.full((B, F + 1, ry * rx), K * cap, dtype=q.dtype, device=dev)
        q_ext.scatter_(1, big_ids[..., None].expand(B, big_k, ry * rx), q_g)
        q_full = torch.cat([q_b, q_ext[:, :F]], dim=-1)
    return BinState(
        idx=idx.to(torch.int32),
        counts=counts.to(torch.int32),
        q=q_full.to(torch.int32),
        overflow=overflow,
    )


def bin_count(
    lox, loy, hix, hiy, valid, suby=None,
    *, H: int, W: int, tile_h: int, tile_w: int, cap: int,
    ry: int = 4, rx: int = 2, big_k: int = 0,
) -> BinState:
    """Bin (margin-dilated) triangle bboxes [..., F] into tiles. Any number
    of leading batch axes; see BinState.

    big_k > 0 enables span-classed enumeration (q then has R = 2 + ry*rx
    columns); suby [..., F] (bbox center y, image px) enables row-sub-classed
    bins."""
    batch = valid.shape[:-1]
    F = valid.shape[-1]

    def flat(a):
        return None if a is None else a.reshape(-1, F)

    st = _bin_count_flat(
        flat(lox), flat(loy), flat(hix), flat(hiy), flat(valid), flat(suby),
        H, W, tile_h, tile_w, cap, ry, rx, big_k,
    )
    return BinState(
        idx=st.idx.reshape(batch + st.idx.shape[1:]),
        counts=st.counts.reshape(batch + st.counts.shape[1:]),
        q=st.q.reshape(batch + st.q.shape[1:]),
        overflow=st.overflow.reshape(batch),
    )


# ---------------------------------------------------------------------------
# Record packing with an analytic (gather-only) backward. Flat batch [B, ...].
# ---------------------------------------------------------------------------


def _tile_origins(K: int, n_tx: int, th: int, tw: int, device=None):
    t = torch.arange(K, dtype=torch.float32, device=device)
    return (t % n_tx) * tw, torch.div(t, n_tx, rounding_mode="floor") * th  # x0, y0


def _shift_rows(g, x0b, y0b, n_rec):
    """[B, 13, K, cap] gathered fields -> [B, K, n_rec, cap] tile-local."""
    a0, b0, c0, a1, b1, c1, a2, b2, c2 = (g[:, k] for k in range(9))
    rows = [
        a0, b0, c0 + a0 * x0b + b0 * y0b,
        a1, b1, c1 + a1 * x0b + b1 * y0b,
        a2, b2, c2 + a2 * x0b + b2 * y0b,
        g[:, 9] - x0b, g[:, 10] - y0b, g[:, 11] - x0b, g[:, 12] - y0b,
    ]
    zero = torch.zeros_like(a0)
    rec = torch.stack(rows + [zero] * (n_rec - 13), dim=1)  # [B, n_rec, K, cap]
    return rec.transpose(1, 2)


def _pack(fields, idx, n_tx, tile_h, tile_w, n_rec):
    """The record pack: fields [B, 13, F] gathered at idx [B, K, cap] and
    shifted tile-local -> [B, K, n_rec, cap]."""
    B, _, F = fields.shape
    K, cap = idx.shape[-2:]
    x0, y0 = _tile_origins(K, n_tx, tile_h, tile_w, fields.device)
    fpad = torch.cat([fields, fields.new_zeros((B, 13, 1))], dim=-1)
    # One frame at a time: an index expanded over the 13 fields would be a
    # [B, 13, K*cap] int64 temporary.
    g = torch.stack([fpad[b].index_select(1, idx[b].reshape(-1).long())
                     for b in range(B)]).reshape(B, 13, K, cap)
    return _shift_rows(g, x0[:, None], y0[:, None], n_rec)


def _unshift_rows(drec, n_tx, tile_h, tile_w):
    """Transpose of the pack's tile-local shift: drec [B, K, n_rec, cap] ->
    dg [B, 13, K*cap + 1], the last column zero (the gather's sentinel).
    c' = c + a*x0 + b*y0 contributes dc'*x0 to da and dc'*y0 to db; the
    bbox shift is a constant."""
    B, K, _, cap = drec.shape
    x0, y0 = _tile_origins(K, n_tx, tile_h, tile_w, drec.device)
    x0b, y0b = x0[:, None], y0[:, None]
    d = drec.transpose(1, 2)  # [B, n_rec, K, cap]
    rows = []
    for e in range(3):
        da, db, dc = d[:, 3 * e], d[:, 3 * e + 1], d[:, 3 * e + 2]
        rows += [da + dc * x0b, db + dc * y0b, dc]
    rows += [d[:, 9], d[:, 10], d[:, 11], d[:, 12]]
    dg = torch.stack(rows, dim=1).reshape(B, 13, K * cap)
    return torch.cat([dg, dg.new_zeros((B, 13, 1))], dim=-1)


def _gather_at_q(dg, q):
    """Gather-only transpose of the pack's gather: dfields[b, :, f] =
    Σ_r dg[b, :, q[b, f, r]] (q = K*cap, dg's zero column, where the entry
    is unused). dg [B, 13, K*cap + 1], q [B, F, R] -> [B, 13, F]."""
    F = q.shape[1]
    return torch.stack([
        dg[b].index_select(1, q[b].reshape(-1).long()).reshape(13, F, -1).sum(-1)
        for b in range(dg.shape[0])
    ])


class _PackRecords(torch.autograd.Function):
    """fields [B, 13, F] -> records [B, K, n_rec, cap]; backward gathers."""

    @staticmethod
    def forward(ctx, fields, idx, q, n_tx, tile_h, tile_w, n_rec):
        ctx.save_for_backward(q)
        ctx.meta = (n_tx, tile_h, tile_w)
        return _pack(fields, idx, n_tx, tile_h, tile_w, n_rec)

    @staticmethod
    def backward(ctx, drec):
        (q,) = ctx.saved_tensors
        dfields = _gather_at_q(_unshift_rows(drec, *ctx.meta), q)
        return dfields, None, None, None, None, None, None


def pack_records_counted(fields, idx, q, n_tx, tile_h, tile_w, n_rec):
    """fields [B, 13, F] + bins -> records [B, n_tiles, n_rec, cap].

    idx: [B, n_tiles, cap] int (BinState.idx), q: [B, F, R] int
    (BinState.q). Field rows: a0 b0 c0 a1 b1 c1 a2 b2 c2 lox loy hix hiy
    (tiled._edge_fields_soa), shifted into tile-local pixel coordinates,
    zero-padded to n_rec rows. Linear in ``fields``; the backward is a pure
    gather at ``q`` (deterministic, no atomics)."""
    return _PackRecords.apply(fields, idx, q, int(n_tx), int(tile_h), int(tile_w),
                              int(n_rec))


class _CountedSilhouette(torch.autograd.Function):
    """fields [B, 13, F] + bins -> clipped coverage tiles [B, K, th, tw]
    through the record pack and K5, with one backward: K5b written through
    the pack's transpose (dg), then the gather at q. No dense d(record)."""

    @staticmethod
    def forward(ctx, fields, idx, q, counts, n_tx, meta):
        from ..ops.pose_raster import dispatch
        from ..ops.tile_raster import TRI_RECORD, pad_cap, tile_fwd_cuda, tile_fwd_plain

        rec = pad_cap(_pack(fields, idx, n_tx, meta.th, meta.tw, TRI_RECORD)).contiguous()
        counts = counts.to(torch.int32).contiguous()
        out, acc = dispatch(tile_fwd_cuda, tile_fwd_plain, rec, counts, meta)
        ctx.save_for_backward(rec, counts, acc, q)
        ctx.meta = (meta, n_tx, idx.shape[-1])
        return out

    @staticmethod
    def backward(ctx, g):
        from ..ops.pose_raster import dispatch
        from ..ops.tile_raster import tile_bwd_counted_cuda, tile_bwd_counted_plain

        rec, counts, acc, q = ctx.saved_tensors
        meta, n_tx, cap = ctx.meta
        dg = dispatch(tile_bwd_counted_cuda, tile_bwd_counted_plain, rec, counts, acc,
                      g.to(torch.float32).contiguous(), meta, n_tx, cap)
        return _gather_at_q(dg, q), None, None, None, None, None


def counted_silhouette(fields, idx, q, counts, n_tx, th, tw, sharpness=1.0):
    """fields [B, 13, F] + bins (BinState idx [B, K, cap], q [B, F, R],
    counts [B, K]) -> soft coverage tiles [B, K, th, tw] in [0, 1]: the
    record pack followed by K5, differentiable in ``fields``. The same
    function as pack_records_counted then tile_silhouette; its backward runs
    the counted K5b, whose output the gather at q reads directly."""
    from ..ops.tile_raster import TileMeta

    meta = TileMeta(int(th), int(tw), float(sharpness))
    return _CountedSilhouette.apply(fields, idx, q, counts, int(n_tx), meta)


# ---------------------------------------------------------------------------
# Full silhouette path (fields -> bins -> records -> K5)
# ---------------------------------------------------------------------------


def _rect_window(H: int, W: int, cfg):
    """(ry, rx): the static tile-rect window; rect 0 = auto, the full grid on
    small grids (exact for any triangle size), a bounded window on large
    ones (bboxes beyond it set the overflow flag)."""
    n_ty, n_tx = _cdiv(H, cfg.tile_h), _cdiv(W, cfg.tile_w)
    if n_ty * n_tx <= 64:
        auto_ry, auto_rx = n_ty, n_tx
    else:
        auto_ry = min(n_ty, max(2, 64 // cfg.tile_h + 1))
        auto_rx = min(n_tx, max(2, 64 // cfg.tile_w + 1))
    ry = min(cfg.rect_y, n_ty) if cfg.rect_y else auto_ry
    rx = min(cfg.rect_x, n_tx) if cfg.rect_x else auto_rx
    return ry, rx


def fields_and_bins(soa, H, W, cfg, margin: float | None = None):
    """Edge-field setup + counting binning for flat-batched SoA triangles.

    soa: TrianglesSoA with ONE leading batch axis ([B, 3, F] / [B, F]).
    Returns (fields [B, 13, F], BinState with [B, ...] leaves)."""
    m = cfg.margin if margin is None else margin
    fl = _edge_fields_soa(soa)
    fields = torch.stack(fl, dim=-2)
    lox, loy, hix, hiy = (f.detach() for f in fl[9:13])
    ry, rx = _rect_window(H, W, cfg)
    state = bin_count(
        lox - m, loy - m, hix + m, hiy + m, soa.valid,
        H=H, W=W, tile_h=cfg.tile_h, tile_w=cfg.tile_w, cap=cfg.capacity,
        ry=ry, rx=rx, big_k=cfg.bin_big_k,
    )
    return fields, state


def silhouette_counted(
    soa,
    H: int,
    W: int,
    cfg,
    sharpness: float = 1.0,
    state: BinState | None = None,
    return_overflow: bool = False,
):
    """Soft silhouette via counting-sort binning and K5 (TrianglesSoA, any
    batch), differentiable in the triangles' pixel coordinates.

    Pass a precomputed ``state`` (from fields_and_bins on the FLATTENED
    batch) to reuse bins across optimizer steps while the triangles stay
    within the binning margin of where it was built."""
    batch = soa.valid.shape[:-1]
    n = math.prod(batch)
    flat = type(soa)(*(a.reshape((n,) + a.shape[len(batch):]) for a in soa))
    if state is None:
        fields, state = fields_and_bins(flat, H, W, cfg)
    else:
        fields = torch.stack(_edge_fields_soa(flat), dim=-2)
    n_tx = _cdiv(W, cfg.tile_w)
    tiles = counted_silhouette(fields, state.idx, state.q, state.counts, n_tx, cfg.tile_h,
                               cfg.tile_w, sharpness)
    img = _untile(tiles, H, W, cfg).reshape(batch + (H, W))
    ov = torch.any(state.overflow)
    return (img, ov) if return_overflow else img
