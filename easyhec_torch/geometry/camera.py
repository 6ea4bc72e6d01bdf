"""Pinhole camera projection, OpenCV convention.

Torch counterpart of easyhec_tpu/geometry/camera.py:

    u = fx · X/Z + cx ,  v = fy · Y/Z + cy ,   +Z in front of the camera,
    pixel (ix, iy) has center (ix + 0.5, iy + 0.5), row iy down.

Near/far only gate validity.
"""
from __future__ import annotations

import torch

NEAR_DEFAULT = 0.001  # matches the reference near/far
FAR_DEFAULT = 10.0

__all__ = ["NEAR_DEFAULT", "FAR_DEFAULT", "project_points", "look_at"]


def project_points(K: torch.Tensor, pts_cam: torch.Tensor, eps: float = 1e-9):
    """Project camera-frame points [..., 3] with K [3, 3].

    Returns (uv [..., 2], z [...]); z is not clamped."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    z = pts_cam[..., 2]
    z_safe = torch.where(
        z.abs() < eps,
        torch.where(z < 0, torch.full_like(z, -eps), torch.full_like(z, eps)),
        z,
    )
    u = fx * pts_cam[..., 0] / z_safe + cx
    v = fy * pts_cam[..., 1] / z_safe + cy
    return torch.stack([u, v], dim=-1), z


def look_at(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Camera-to-world pose ``T_w_cam`` with +Z looking from eye to target
    (columns = camera axes in the world frame, translation = eye). Invert
    it for a world-to-camera extrinsic."""
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right, dim=-1)  # OpenCV y axis points down
    T = torch.eye(4, dtype=eye.dtype, device=eye.device)
    T[:3, :3] = torch.stack([right, down, fwd], dim=-1)
    T[:3, 3] = eye
    return T
