"""Brute-force rasterizer: every pixel against every triangle.

Torch counterpart of easyhec_tpu/render/raster_jnp.py (``render.mode=brute``
of ``RobotRenderer``): the correctness reference of the tiled rasterizers,
and a usable path for small images or few triangles. Its work is dense,
O(H·W·F) per frame: one [P, 3F] edge evaluation (raster_core), so the
frames of a batch run one after another to bound the temporaries to one
frame's. Plain PyTorch on any device; no kernel of its own.
"""
from __future__ import annotations

import math

import torch

from .projection import Triangles2D
from .raster_core import (EdgeData, build_edges, clip01, coverage_from_edges,
                          depth_from_edges, pixel_grid)

__all__ = ["silhouette_bruteforce", "depth_bruteforce"]


def _frames(tris: Triangles2D):
    """Per-frame edges of [..., F, ...] triangles: (batch shape, [EdgeData])."""
    batch = tris.valid.shape[:-1]
    n = math.prod(batch)
    edges = build_edges(tris.uv, tris.z, tris.valid)
    flat = EdgeData(*(a.reshape((n,) + a.shape[len(batch):]) for a in edges))
    return batch, [EdgeData(*(a[i] for a in flat)) for i in range(n)]


def silhouette_bruteforce(tris: Triangles2D, H: int, W: int, sharpness: float = 1.0
                          ) -> torch.Tensor:
    """[..., F, …] screen triangles -> [..., H, W] soft silhouette in [0, 1].

    Union semantics: clamp(Σ per-triangle coverage, 0, 1)."""
    batch, frames = _frames(tris)
    pix = pixel_grid(H, W, device=tris.uv.device)
    out = [clip01(coverage_from_edges(pix, e, sharpness).sum(dim=-1)).reshape(H, W)
           for e in frames]
    return torch.stack(out).reshape(batch + (H, W))


@torch.no_grad()
def depth_bruteforce(tris: Triangles2D, H: int, W: int):
    """-> (depth [..., H, W] metric camera-space z, 0 = background;
    tri_id [..., H, W] int32, -1 = background)."""
    batch, frames = _frames(tris)
    pix = pixel_grid(H, W, device=tris.uv.device)
    zs, ids = zip(*(depth_from_edges(pix, e) for e in frames))
    return (torch.stack(zs).reshape(batch + (H, W)),
            torch.stack(ids).reshape(batch + (H, W)))
