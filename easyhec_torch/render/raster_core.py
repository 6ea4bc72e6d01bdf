"""Core rasterization math shared by the brute-force and tiled rasterizers.

Torch counterpart of easyhec_tpu/render/raster_core.py: per-triangle
normalized edge functions, screen-space barycentric line functions, 1/z and
bboxes (``build_edges``), homogeneous pixel-center grids (``pixel_grid``),
the soft coverage of every pixel by every triangle (``coverage_from_edges``)
with its bbox distance (``bbox_distance``), and hard nearest-depth
visibility (``depth_from_edges``).

The edge functions are one [P, 3] × [3, E] f32 product (``eval_lines``), as
the JAX package's ``Precision.HIGHEST`` einsum: on the card it runs in
full f32 because ``easyhec_torch.resolve_device`` turns TF32 off for the
whole package whenever it resolves CUDA (every renderer is built through
it). On the CPU it rounds as XLA's CPU dot does (a fused multiply-add chain
over k = 0, 1, 2), so the edge distances agree bit for bit.

Soft coverage of a pixel by a triangle is ``clamp(0.5 + s·dmin, 0, 1)`` with
dmin the signed distance to the boundary (min over the three normalized
edge functions, orientation-corrected, and the bbox half-planes); the union
over triangles is ``clamp(Σ coverage, 0, 1)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["EdgeData", "build_edges", "pixel_grid", "coverage_from_edges", "bbox_distance",
           "depth_from_edges", "clip01", "eval_lines"]


class EdgeData(NamedTuple):
    """Per-triangle rasterization coefficients (leading batch axes allowed).

    abc:      [..., F, 3, 3] normalized edge lines (a, b, c): a·px + b·py + c
              is the signed distance (pixels) to edge i, positive inside
    zinv:     [..., F, 3] per-vertex 1/z for perspective-correct depth
    bary_abc: [..., F, 3, 3] screen-space barycentric line functions
    bbox:     [..., F, 4] (lo_x, lo_y, hi_x, hi_y)
    valid:    [..., F] bool
    """

    abc: torch.Tensor
    zinv: torch.Tensor
    bary_abc: torch.Tensor
    bbox: torch.Tensor
    valid: torch.Tensor


def build_edges(tri_uv: torch.Tensor, tri_z: torch.Tensor, valid: torch.Tensor) -> EdgeData:
    """Edge/barycentric line coefficients from screen triangles.

    tri_uv: [..., F, 3, 2], tri_z: [..., F, 3], valid: [..., F]."""
    v0, v1, v2 = tri_uv[..., 0, :], tri_uv[..., 1, :], tri_uv[..., 2, :]
    # Twice the signed area (CCW positive in x-right/y-down pixel space).
    area2 = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
        v1[..., 1] - v0[..., 1]
    ) * (v2[..., 0] - v0[..., 0])
    orient = torch.where(area2 >= 0, torch.ones_like(area2), -torch.ones_like(area2))

    def edge(va, vb):
        a = -(vb[..., 1] - va[..., 1])
        b = vb[..., 0] - va[..., 0]
        inv_len = orient / torch.clamp(torch.sqrt(a * a + b * b), min=1e-12)
        a = a * inv_len
        b = b * inv_len
        c = -(a * va[..., 0] + b * va[..., 1])
        return torch.stack([a, b, c], dim=-1)

    # Edge i runs from v_i to v_{i+1}; the edge opposite vertex i is edge i+1.
    e0, e1, e2 = edge(v0, v1), edge(v1, v2), edge(v2, v0)
    abc = torch.stack([e0, e1, e2], dim=-2)
    bary_abc = torch.stack([e1, e2, e0], dim=-2)
    zinv = 1.0 / torch.clamp(tri_z, min=1e-9)
    lo = tri_uv.amin(dim=-2)
    hi = tri_uv.amax(dim=-2)
    bbox = torch.cat([lo, hi], dim=-1)
    return EdgeData(abc=abc, zinv=zinv, bary_abc=bary_abc, bbox=bbox, valid=valid)


def pixel_grid(H: int, W: int, y0: int = 0, x0: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Homogeneous pixel centers [H*W, 3] (px, py, 1) of a tile whose
    top-left pixel is (x0, y0)."""
    ys = y0 + torch.arange(H, dtype=dtype, device=device) + 0.5
    xs = x0 + torch.arange(W, dtype=dtype, device=device) + 0.5
    px = xs[None, :].expand(H, W).reshape(-1)
    py = ys[:, None].expand(H, W).reshape(-1)
    return torch.stack([px, py, torch.ones_like(px)], dim=-1)


def bbox_distance(pix: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """Signed distance of pixels [P, 3] to bboxes [..., F, 4] (positive
    inside) -> [..., P, F]."""
    px = pix[..., 0][:, None]
    py = pix[..., 1][:, None]
    lo_x, lo_y = bbox[..., None, :, 0], bbox[..., None, :, 1]
    hi_x, hi_y = bbox[..., None, :, 2], bbox[..., None, :, 3]
    return torch.minimum(torch.minimum(px - lo_x, hi_x - px),
                         torch.minimum(py - lo_y, hi_y - py))


def clip01(x: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, 0, 1) as jnp computes it, maximum then minimum, so a value
    on a bound splits its gradient evenly as jnp's does."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def coverage_from_edges(pix: torch.Tensor, edges: EdgeData, sharpness: float = 1.0
                        ) -> torch.Tensor:
    """Soft coverage of each pixel by each triangle: pix [P, 3] homogeneous
    pixel centers, edges with [..., F, ...] -> [..., P, F] in [0, 1]
    (``clamp(0.5 + s·dmin, 0, 1)``, zero for invalid triangles)."""
    F = edges.abc.shape[-3]
    d = eval_lines(pix, edges.abc.reshape(edges.abc.shape[:-3] + (3 * F, 3)))
    dmin = d.reshape(d.shape[:-1] + (F, 3)).amin(dim=-1)  # ties split as jnp.min
    dmin = torch.minimum(dmin, bbox_distance(pix, edges.bbox))
    cov = clip01(0.5 + sharpness * dmin)
    return torch.where(edges.valid[..., None, :], cov, torch.zeros_like(cov))


def eval_lines(pix, coef):
    """Line functions coef [..., E, 3] at pixels [P, 3] -> [..., P, E]
    (a·px + b·py + c), one f32 matmul: full f32 on the card through the
    package-wide TF32 switch in ``easyhec_torch.resolve_device``, as the
    JAX package's Precision.HIGHEST."""
    return torch.matmul(pix, coef.transpose(-1, -2))


def depth_from_edges(pix: torch.Tensor, edges: EdgeData):
    """Hard visibility: per-pixel nearest depth and triangle index.

    Returns (z [P], tri_id [P] int32, -1 for background). The inside test is
    the hard version of the soft coverage (all edge distances >= 0); the
    nearest triangle is the first minimum over the triangle axis."""
    F = edges.abc.shape[-3]
    d = eval_lines(pix, edges.abc.reshape(edges.abc.shape[:-3] + (3 * F, 3)))
    d = d.reshape(d.shape[:-1] + (F, 3))
    inside = torch.all(d >= 0.0, dim=-1) & edges.valid[..., None, :]
    b = eval_lines(pix, edges.bary_abc.reshape(edges.bary_abc.shape[:-3] + (3 * F, 3)))
    b = b.reshape(b.shape[:-1] + (F, 3))
    bsum = b.sum(dim=-1, keepdim=True)
    bary = b / torch.where(bsum.abs() < 1e-12, torch.ones_like(bsum), bsum)
    zinv = (bary * edges.zinv[..., None, :, :]).sum(dim=-1)
    z = 1.0 / torch.clamp(zinv, min=1e-9)
    z_masked = torch.where(inside, z, torch.full_like(z, float("inf")))
    zmin, tri_id = z_masked.min(dim=-1)
    hit = torch.isfinite(zmin)
    return (torch.where(hit, zmin, torch.zeros_like(zmin)),
            torch.where(hit, tri_id.to(torch.int32), torch.full_like(tri_id, -1).to(torch.int32)))
