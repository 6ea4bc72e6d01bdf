"""Counting-sort tile binning.

Torch counterpart of easyhec_tpu/render/binning.py::bin_count. The tiles
overlapped by a triangle's (margin-dilated) bbox form an axis-aligned
rectangle, so the (triangle, tile) incidence is enumerated densely as static
"rect slots" per triangle; sorting the enumerated keys then yields the
per-tile triangle lists.

The JAX version ranks entries with a counting sort whose slot is the stable
rank of an entry within its key (per-chunk histograms + a triangular
matmul). A stable ``torch.sort`` on the keys produces exactly those ranks,
so ``idx``, ``counts``, ``q`` and ``overflow`` agree bit for bit given the
same bboxes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .tiled import _cdiv, _topk_compact

__all__ = ["BinState", "bin_count"]


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
