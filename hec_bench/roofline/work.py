"""Frozen work counts and peaks for the rooflines.

The bound of a kernel call is max(bytes / HBM_BYTES_PER_S, FP32 ops /
FP32_OPS_PER_S): the published H100 SXM peaks (NVIDIA data sheet; the
card's power limit is printed beside every share). Operations count the
pixel-triangle pairs that the inputs need, those inside each counted
triangle's bbox dilated by the soft band (``band_pairs``, from the
reference's own projection), times the per-pair and per-triangle
arithmetic of the silhouette and of its backward. Those four constants are
copied from chip_smoke.py:203-209 (OPS_FWD_PAIR, OPS_BWD_PAIR,
OPS_FWD_LANE, OPS_BWD_LANE), counted there from the kernel source; they are
frozen here, so a later kernel that does the same job reads the same work
over its own time. Bytes count each input read once and each output
written once. Nothing depends on tiles, caps or bin states.
"""
from __future__ import annotations

import torch

from ..reference.render import Scene, project

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores
OPS_FWD_PAIR, OPS_BWD_PAIR = 27, 40
OPS_FWD_TRI, OPS_BWD_TRI = 120, 220
F32 = 4


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def band_pairs(sc: Scene, Tc, lp) -> tuple[int, int]:
    """(pixel-triangle pairs whose pixel centre lies strictly inside the
    triangle's bbox dilated by 0.5/s and inside the image, counted
    triangles) over the frames lp [B, L, 4, 4] under Tc."""
    with torch.no_grad():
        u, v, valid = project(sc, Tc, lp)
        band = 0.5 / sc.s
        pairs = 0
        for b in range(u.shape[0]):
            ub, vb = u[b][valid[b]], v[b][valid[b]]
            x0 = (torch.floor(ub.amin(-1) - band - 0.5) + 1).clamp(min=0)
            x1 = (torch.ceil(ub.amax(-1) + band - 0.5) - 1).clamp(max=sc.W - 1)
            y0 = (torch.floor(vb.amin(-1) - band - 0.5) + 1).clamp(min=0)
            y1 = (torch.ceil(vb.amax(-1) + band - 0.5) - 1).clamp(max=sc.H - 1)
            pairs += int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)).sum())
        return pairs, int(valid.sum())


def loss_work(sc: Scene, Tc, lp) -> tuple[float, float]:
    """(bytes, ops) of one mask-loss forward and backward over the frames:
    reads the masks, the link-frame corners, the link poses and the pose;
    writes the loss and the 6-vector gradient."""
    pairs, tris = band_pairs(sc, Tc, lp)
    B = lp.shape[0]
    nbytes = F32 * (B * sc.H * sc.W + sc.corners.shape[0] * 9 + lp[0].numel() * B + 16 + 7)
    ops = pairs * (OPS_FWD_PAIR + OPS_BWD_PAIR) + tris * (OPS_FWD_TRI + OPS_BWD_TRI)
    return nbytes, ops


def silhouette_work(sc: Scene, Tc, lp) -> tuple[float, float]:
    """(bytes, ops) of one silhouette forward over the frames: reads the
    corners, the link poses and the pose; writes the images."""
    pairs, tris = band_pairs(sc, Tc, lp)
    B = lp.shape[0]
    nbytes = F32 * (B * sc.H * sc.W + sc.corners.shape[0] * 9 + lp[0].numel() * B + 16)
    return nbytes, pairs * OPS_FWD_PAIR + tris * OPS_FWD_TRI
