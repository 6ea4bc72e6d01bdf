"""Triangle setup from statically face-expanded vertices.

Torch counterpart of easyhec_tpu/render/projection.py::setup_triangles_corners:
all links of all frames are transformed in one batched computation and
projected straight to OpenCV pixel coordinates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera

__all__ = ["TrianglesSoA", "setup_triangles_corners"]


class TrianglesSoA(NamedTuple):
    """Structure-of-arrays screen triangles.

    u, v:  [..., 3, F] pixel coordinates, vertex on axis -2
    z:     [..., 3, F] camera-space depths
    valid: [..., F] bool
    """

    u: torch.Tensor
    v: torch.Tensor
    z: torch.Tensor
    valid: torch.Tensor


def setup_triangles_corners(
    corners_rest: torch.Tensor,
    face_mesh_onehot: torch.Tensor,
    mesh_poses: torch.Tensor,
    K: torch.Tensor,
    near: float = camera.NEAR_DEFAULT,
    far: float = camera.FAR_DEFAULT,
    eps: float = 1e-9,
    cull_backfaces: bool = False,
) -> TrianglesSoA:
    """Project face-corner arrays under per-mesh camera poses.

    corners_rest:     [3 corners, 4, F] static homogeneous rest positions
    face_mesh_onehot: [M, F] static 0/1 link membership
    mesh_poses:       [..., M, 4, 4] camera-from-mesh transforms

    A triangle is valid when all corners lie in (near, far) and its screen
    area is not degenerate; with ``cull_backfaces`` also when its outward
    normal faces the camera (exact for closed, outward-oriented meshes).
    """
    P = mesh_poses[..., :3, :4]  # [..., M, 3, 4]
    pr = torch.einsum("...mij,mf->...ijf", P, face_mesh_onehot)  # [..., 3, 4, F]

    def corner(c):
        r = corners_rest[c]  # [4, F]
        return [
            pr[..., i, 0, :] * r[0]
            + pr[..., i, 1, :] * r[1]
            + pr[..., i, 2, :] * r[2]
            + pr[..., i, 3, :] * r[3]
            for i in range(3)
        ]

    xs, ys, zs = zip(corner(0), corner(1), corner(2))
    x = torch.stack(xs, dim=-2)  # [..., 3, F]
    y = torch.stack(ys, dim=-2)
    z = torch.stack(zs, dim=-2)

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    z_safe = torch.where(
        z.abs() < eps,
        torch.where(z < 0, torch.full_like(z, -eps), torch.full_like(z, eps)),
        z,
    )
    u = fx * x / z_safe + cx
    v = fy * y / z_safe + cy

    in_frustum = torch.all((z > near) & (z < far), dim=-2)
    e01u, e01v = u[..., 1, :] - u[..., 0, :], v[..., 1, :] - v[..., 0, :]
    e02u, e02v = u[..., 2, :] - u[..., 0, :], v[..., 2, :] - v[..., 0, :]
    area2 = e01u * e02v - e01v * e02u
    valid = in_frustum & (area2.abs() > 1e-12)
    if cull_backfaces:
        x0, y0, z0 = x[..., 0, :], y[..., 0, :], z[..., 0, :]
        e1 = (x[..., 1, :] - x0, y[..., 1, :] - y0, z[..., 1, :] - z0)
        e2 = (x[..., 2, :] - x0, y[..., 2, :] - y0, z[..., 2, :] - z0)
        nx = e1[1] * e2[2] - e1[2] * e2[1]
        ny = e1[2] * e2[0] - e1[0] * e2[2]
        nz = e1[0] * e2[1] - e1[1] * e2[0]
        valid = valid & (nx * x0 + ny * y0 + nz * z0 < 0.0)
    return TrianglesSoA(u=u, v=v, z=z, valid=valid)
