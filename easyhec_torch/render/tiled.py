"""Tile configuration and tile-layout helpers.

Torch counterpart of the parts of easyhec_tpu/render/tiled.py that the
compact calibration path uses: ``TileConfig`` (same fields and defaults, so
a configuration moves between the packages unchanged), ``_untile`` and
``_topk_compact``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TileConfig"]


class TileConfig(NamedTuple):
    """Rasterizer tiling and binning budgets (see easyhec_tpu's TileConfig
    for the long-form notes on each field). The port implements the fused
    compact-chunk route (``fused=True``, ``compact_chunks > 0``)."""

    tile_h: int = 8
    tile_w: int = 128
    capacity: int = 256  # max triangles per tile bin
    use_pallas: bool = True  # kept for configuration parity; unused here
    binner: str = "count"  # counting-sort binner (binning.bin_count)
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


def _topk_compact(overlap: torch.Tensor, k: int, sentinel: int):
    """Compact boolean rows to ascending index lists.

    overlap: [R, N] bool. Returns (ids [R, k] int32 — the first k hits in
    ascending order, ``sentinel`` for empty slots; counts [R]; overflowed
    []). A stable sort of {index if hit else N} is the exact counterpart of
    the JAX version's top_k over negated indices."""
    R, N = overlap.shape
    col = torch.arange(N, device=overlap.device).expand(R, N)
    key = torch.where(overlap, col, torch.full_like(col, N))
    srt = torch.sort(key, dim=-1, stable=True).values[:, :k]
    if srt.shape[-1] < k:
        pad = torch.full((R, k - srt.shape[-1]), N, dtype=srt.dtype, device=srt.device)
        srt = torch.cat([srt, pad], dim=-1)
    ids = torch.where(srt < N, srt, torch.full_like(srt, sentinel)).to(torch.int32)
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
