"""The benchmark's own geometry: URDF reading, the procedural link meshes,
forward kinematics, SE(3) maps and the camera rig, in NumPy (float64 where
the arithmetic is the reference's) and plain PyTorch.

Imports nothing of the program under test. The mesh construction is a
frozen copy of the arithmetic of ``easyhec_torch/robot/mesh.py``
(``make_box`` :473, ``make_cylinder`` :499, ``subdivide_to_max_edge`` :577)
and ``urdf.py::rpy_to_matrix`` :39, so
that the benchmark can hand both sides the same triangles in the same order.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch


# ------------------------------------------------------------------ URDF


def rpy_to_matrix(rpy) -> np.ndarray:
    r, p, y = [float(v) for v in rpy]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _origin(el) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    if el is None:
        return T
    T[:3, :3] = rpy_to_matrix(el.get("rpy", "0 0 0").split())
    T[:3, 3] = [float(v) for v in el.get("xyz", "0 0 0").split()]
    return T


@dataclass
class Joint:
    name: str
    kind: str
    parent: str
    child: str
    origin: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float


@dataclass
class Robot:
    """Links (name -> list of (kind, params, origin)) and the joints, in
    document order; revolute and fixed joints only."""

    links: dict = field(default_factory=dict)
    joints: list = field(default_factory=list)

    @property
    def actuated(self) -> list[Joint]:
        return [j for j in self.joints if j.kind != "fixed"]

    @property
    def limits(self) -> np.ndarray:
        return np.array([[j.lower, j.upper] for j in self.actuated], np.float32)


def read_urdf(path) -> Robot:
    root = ET.parse(Path(path)).getroot()
    robot = Robot()
    for link in root.findall("link"):
        geoms = []
        for vis in link.findall("visual"):
            g = vis.find("geometry")
            org = _origin(vis.find("origin"))
            if g.find("box") is not None:
                size = np.array(g.find("box").get("size").split(), np.float32)
                geoms.append(("box", size, org))
            elif g.find("cylinder") is not None:
                c = g.find("cylinder")
                geoms.append(("cylinder", (float(c.get("radius")), float(c.get("length"))), org))
            else:
                raise ValueError(f"link {link.get('name')}: only box and cylinder visuals")
        robot.links[link.get("name")] = geoms
    for j in root.findall("joint"):
        kind = j.get("type")
        if kind not in ("revolute", "fixed"):
            raise ValueError(f"joint {j.get('name')}: {kind} is not read here")
        ax = j.find("axis")
        axis = np.array((ax.get("xyz") if ax is not None else "1 0 0").split(), np.float32)
        axis = axis / np.linalg.norm(axis)
        lim = j.find("limit")
        robot.joints.append(Joint(
            j.get("name"), kind, j.find("parent").get("link"), j.find("child").get("link"),
            _origin(j.find("origin")), axis,
            float(lim.get("lower", 0.0)) if lim is not None else 0.0,
            float(lim.get("upper", 0.0)) if lim is not None else 0.0))
    return robot


# ------------------------------------------------------------------ meshes


def make_box(extents) -> tuple[np.ndarray, np.ndarray]:
    ex, ey, ez = [e / 2 for e in extents]
    v = np.array([[-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
                  [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez]],
                 np.float32) + np.zeros(3, np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)
    return v, f


def make_cylinder(radius, height, sections=24) -> tuple[np.ndarray, np.ndarray]:
    ang = np.linspace(0, 2 * np.pi, sections, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    bot = np.concatenate([ring, np.full((sections, 1), -height / 2, np.float32)], -1)
    top = np.concatenate([ring, np.full((sections, 1), height / 2, np.float32)], -1)
    centers = np.array([[0, 0, -height / 2], [0, 0, height / 2]], np.float32)
    v = np.concatenate([bot, top, centers]).astype(np.float32)
    cb, ct = 2 * sections, 2 * sections + 1
    f = []
    for i in range(sections):
        j = (i + 1) % sections
        f += [[i, j, sections + i], [j, sections + j, sections + i]]
        f += [[cb, j, i], [ct, sections + i, sections + j]]
    return v, np.asarray(f, np.int32)


def subdivide(v, f, max_edge: float, max_passes: int = 12):
    """Longest-edge midpoint bisection until every edge is under max_edge."""
    if max_edge <= 0:
        return v, f
    verts = np.asarray(v, np.float64)
    faces = np.asarray(f, np.int64)
    for _ in range(max_passes):
        tri = verts[faces]
        e = np.stack([np.linalg.norm(tri[:, 1] - tri[:, 0], axis=1),
                      np.linalg.norm(tri[:, 2] - tri[:, 1], axis=1),
                      np.linalg.norm(tri[:, 0] - tri[:, 2], axis=1)], axis=1)
        longest = e.argmax(axis=1)
        needs = e.max(axis=1) > max_edge
        if not needs.any():
            break
        keep = faces[~needs]
        split = faces[needs]
        li = longest[needs]
        r = np.arange(len(split))
        a, b, c = split[r, li], split[r, (li + 1) % 3], split[r, (li + 2) % 3]
        key = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
        uk, inv = np.unique(key, axis=0, return_inverse=True)
        mids = (verts[uk[:, 0]] + verts[uk[:, 1]]) * 0.5
        m = len(verts) + inv.reshape(-1)
        verts = np.concatenate([verts, mids])
        faces = np.concatenate([keep, np.stack([a, m, c], 1), np.stack([m, b, c], 1)])
    return verts.astype(np.float32), faces.astype(np.int32)


def link_meshes(robot: Robot, names, max_edge: float = 0.0):
    """{name: (vertices [V, 3] f32 in the link frame, faces [F, 3] i32)}: each
    link's visuals merged, then subdivided to ``max_edge`` (0: as read)."""
    out = {}
    for n in names:
        parts = []
        for kind, p, org in robot.links[n]:
            v, f = make_box(tuple(p)) if kind == "box" else make_cylinder(*p)
            R, t = org[:3, :3], org[:3, 3]
            parts.append((np.ascontiguousarray(v @ R.T + t, np.float32), f))
        v, f = parts[0]
        for v2, f2 in parts[1:]:
            f = np.concatenate([f, f2 + len(v)])
            v = np.concatenate([v, v2])
        out[n] = subdivide(v, f, max_edge)
    return out


def corners(meshes: dict, names) -> tuple[np.ndarray, np.ndarray]:
    """Packed triangles: (corners [F, 3, 3] f32 in the link frame, link index
    [F]), the links in ``names`` order."""
    cs, ids = [], []
    for i, n in enumerate(names):
        v, f = meshes[n]
        cs.append(v[f])
        ids.append(np.full(len(f), i, np.int64))
    return np.concatenate(cs), np.concatenate(ids)


# ------------------------------------------------------------------ kinematics


def so3_exp_np(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float64)
    if th < 1e-12:
        return np.eye(3) + Kx
    Kx = Kx / th
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def fk(robot: Robot, qpos: np.ndarray, names) -> np.ndarray:
    """Base-from-link poses [..., len(names), 4, 4] (float64) of the links in
    ``names`` at joint angles qpos [..., n_dof] (actuated joints in document
    order), from the one link that no joint has as its child."""
    q = np.asarray(qpos, np.float64)
    flat = q.reshape(-1, q.shape[-1])
    act = {j.name: i for i, j in enumerate(robot.actuated)}
    children = {j.child for j in robot.joints}
    root = [n for n in robot.links if n not in children]
    out = np.zeros((len(flat), len(names), 4, 4))
    for b, qb in enumerate(flat):
        poses = {root[0]: np.eye(4)}
        todo = list(robot.joints)
        while todo:
            j = next(j for j in todo if j.parent in poses)
            todo.remove(j)
            T = poses[j.parent] @ j.origin.astype(np.float64)
            if j.kind == "revolute":
                J = np.eye(4)
                J[:3, :3] = so3_exp_np(j.axis.astype(np.float64) * qb[act[j.name]])
                T = T @ J
            poses[j.child] = T
        out[b] = np.stack([poses[n] for n in names])
    return out.reshape(q.shape[:-1] + (len(names), 4, 4))


# ------------------------------------------------------------------ SE(3)


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] = (v, w) -> [..., 4, 4]: R = exp(w), t = V(w) v (the
    convention of the program's geometry/se3.py). Series below θ = 1e-3."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    small = th2 < 1e-6
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    A = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2s)
    C = torch.where(small, 1 / 6 - th2 / 120, (th - torch.sin(th)) / (th2s * th))
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    t = ((eye + B[..., None, None] * W + C[..., None, None] * W2) @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def se3_log_np(T: np.ndarray) -> np.ndarray:
    """[4, 4] -> twist (v, w), float64."""
    R, t = T[:3, :3], T[:3, 3]
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = math.acos(c)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    w = vee * (0.5 if th < 1e-8 else th / (2 * math.sin(th)))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        Vinv = np.eye(3) - 0.5 * W
    else:
        A, B = math.sin(th) / th, (1 - math.cos(th)) / th ** 2
        Vinv = np.eye(3) - 0.5 * W + (1 - A / (2 * B)) / th ** 2 * (W @ W)
    return np.concatenate([Vinv @ t, w])


def look_at_np(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-from-base [4, 4] (OpenCV axes: x right, y down, z forward) of a
    camera at ``eye`` looking at ``target``."""
    eye, target, up = (np.asarray(a, np.float64) for a in (eye, target, up))
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Tw = np.eye(4)
    Tw[:3, :3] = np.stack([right, down, fwd], -1)
    Tw[:3, 3] = eye
    return np.linalg.inv(Tw)


def intrinsics(H: int, W: int, f: float, downscale: int = 1) -> np.ndarray:
    """Pinhole K [3, 3] f32 centred in the frame; ``downscale`` s maps it to
    an s-times smaller image pixel-centre exactly (f/s, (c + 0.5)/s − 0.5)."""
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
    if downscale > 1:
        s = downscale
        K[0, 0] /= s
        K[1, 1] /= s
        K[0, 2] = (K[0, 2] + 0.5) / s - 0.5
        K[1, 2] = (K[1, 2] + 0.5) / s - 0.5
    return K.astype(np.float32)
