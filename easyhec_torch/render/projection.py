"""Vertex transform and triangle setup.

Torch counterpart of easyhec_tpu/render/projection.py: all links of all
frames are transformed in one batched computation and projected straight to
OpenCV pixel coordinates. ``setup_triangles_corners`` (SoA, from statically
face-expanded vertices) feeds the fused and unfused silhouettes;
``transform_verts`` + ``setup_triangles`` (AoS ``Triangles2D``) feed the
tiled depth pass.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera

__all__ = [
    "Triangles2D",
    "TrianglesSoA",
    "soa_from_aos",
    "to_aos",
    "setup_triangles_corners",
    "transform_verts_soa",
    "setup_triangles_soa",
    "transform_verts",
    "setup_triangles",
]


class Triangles2D(NamedTuple):
    """Screen-space triangle records (AoS), batched over leading axes.

    uv:    [..., F, 3, 2] pixel-space vertex positions
    z:     [..., F, 3] camera-space depths
    valid: [..., F] bool
    """

    uv: torch.Tensor
    z: torch.Tensor
    valid: torch.Tensor


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

    @property
    def n_faces(self) -> int:
        return self.valid.shape[-1]


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
    return _screen_soa(torch.stack(xs, dim=-2), torch.stack(ys, dim=-2),
                       torch.stack(zs, dim=-2), K, near, far, eps, cull_backfaces)


def _screen_soa(x, y, z, K, near, far, eps, cull_backfaces) -> TrianglesSoA:
    """Camera-frame corners x, y, z [..., 3, F] -> projected, culled
    TrianglesSoA (OpenCV pinhole, whole-triangle near/far cull, degenerate
    cull, optional backface cull)."""
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


def transform_verts_soa(
    verts_xyz: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    vert_mesh_id: torch.Tensor,
    mesh_poses: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SoA rigid transform of packed multi-mesh vertices.

    verts_xyz: three [V] tensors; vert_mesh_id: [V] int; mesh_poses
    [..., M, 4, 4]. Returns (x, y, z), each [..., V]."""
    x0, y0, z0 = verts_xyz
    idx = vert_mesh_id.long()

    def row(i):
        r = [mesh_poses[..., i, j].index_select(-1, idx) for j in range(4)]
        return r[0] * x0 + r[1] * y0 + r[2] * z0 + r[3]

    return row(0), row(1), row(2)


def setup_triangles_soa(
    verts_xyz: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    faces: torch.Tensor,
    K: torch.Tensor,
    near: float = camera.NEAR_DEFAULT,
    far: float = camera.FAR_DEFAULT,
    eps: float = 1e-9,
    cull_backfaces: bool = False,
) -> TrianglesSoA:
    """Project SoA camera-frame vertices (three [..., V]) and gather
    per-triangle records for faces [F, 3] int, with setup_triangles_corners'
    culls. Off the render paths, which go through setup_triangles_corners."""
    f = faces.long()

    def gather(a):  # [..., V] -> [..., 3, F]
        return torch.stack([a.index_select(-1, f[:, i]) for i in range(3)], dim=-2)

    x, y, z = verts_xyz
    return _screen_soa(gather(x), gather(y), gather(z), K, near, far, eps, cull_backfaces)


def soa_from_aos(t: Triangles2D) -> TrianglesSoA:
    return TrianglesSoA(u=t.uv[..., 0].transpose(-1, -2), v=t.uv[..., 1].transpose(-1, -2),
                        z=t.z.transpose(-1, -2), valid=t.valid)


def to_aos(t: TrianglesSoA) -> Triangles2D:
    uv = torch.stack([t.u.transpose(-1, -2), t.v.transpose(-1, -2)], dim=-1)
    return Triangles2D(uv=uv, z=t.z.transpose(-1, -2), valid=t.valid)


def transform_verts(verts: torch.Tensor, vert_mesh_id: torch.Tensor,
                    mesh_poses: torch.Tensor) -> torch.Tensor:
    """Pose packed multi-mesh vertices.

    verts [V, 3]; vert_mesh_id [V] int; mesh_poses [..., M, 4, 4] per-mesh
    rigid transforms. -> [..., V, 3]."""
    idx = vert_mesh_id.long()
    R = mesh_poses[..., :3, :3].index_select(-3, idx)  # [..., V, 3, 3]
    t = mesh_poses[..., :3, 3].index_select(-2, idx)  # [..., V, 3]
    return (R * verts[:, None, :]).sum(-1) + t


def setup_triangles(
    verts_cam: torch.Tensor,
    faces: torch.Tensor,
    K: torch.Tensor,
    near: float = camera.NEAR_DEFAULT,
    far: float = camera.FAR_DEFAULT,
) -> Triangles2D:
    """Project camera-frame vertices [..., V, 3] and gather per-triangle
    screen records; faces [F, 3] int, K [3, 3]. A triangle is valid when
    every corner lies in (near, far) and its screen area is not degenerate."""
    uv, z = camera.project_points(K, verts_cam)
    f = faces.long()
    tri_uv = uv[..., f, :]  # [..., F, 3, 2]
    tri_z = z[..., f]  # [..., F, 3]
    in_frustum = torch.all((tri_z > near) & (tri_z < far), dim=-1)
    e01 = tri_uv[..., 1, :] - tri_uv[..., 0, :]
    e02 = tri_uv[..., 2, :] - tri_uv[..., 0, :]
    area2 = e01[..., 0] * e02[..., 1] - e01[..., 1] * e02[..., 0]
    return Triangles2D(uv=tri_uv, z=tri_z, valid=in_frustum & (area2.abs() > 1e-12))
