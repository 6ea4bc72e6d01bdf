"""Batched forward kinematics as a torch function.

Torch counterpart of easyhec_tpu/robot/kinematics.py: the chain structure
(topology, joint types, origins, axes) is static host data, and
``KinematicChain.fk`` composes the fixed chain of 4×4 transforms for a
whole batch of joint configurations at once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import so3
from .mesh import TriMesh, load_mesh, make_box, make_cylinder
from .urdf import FIXED, PRISMATIC, REVOLUTE, Geometry, RobotModel

__all__ = ["KinematicChain", "build_chain", "load_link_meshes"]


@dataclass(frozen=True)
class _LinkSpec:
    """Static per-link FK recipe."""

    name: str
    parent_index: int  # index into topo-ordered links; -1 for root
    joint_type: int  # FIXED | REVOLUTE | PRISMATIC
    origin: np.ndarray  # [4,4] parent->joint static transform
    axis: np.ndarray  # [3]
    qpos_index: int  # -1 if fixed
    mimic_multiplier: float
    mimic_offset: float


class KinematicChain:
    """Topologically-ordered kinematic chain with batched FK.

    ``link_names`` is the chain (topological) order that ``fk`` returns;
    ``doc_order_names`` the URDF document order."""

    def __init__(self, specs: list[_LinkSpec], doc_order_names: list[str],
                 n_dof: int, limits: np.ndarray):
        self._specs = specs
        self.link_names = [s.name for s in specs]
        self.doc_order_names = doc_order_names
        self.n_links = len(specs)
        self.n_dof = n_dof
        self.joint_limits = limits  # [n_dof, 2]

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    def fk(self, qpos: torch.Tensor) -> torch.Tensor:
        """[..., n_dof] -> [..., n_links, 4, 4] link poses in the base frame.

        Any leading batch axes (e.g. [B, n_dof] for a capture set);
        differentiable in qpos."""
        qpos = torch.as_tensor(qpos, dtype=torch.float32)
        batch = qpos.shape[:-1]
        dev = qpos.device
        eye = torch.eye(4, dtype=torch.float32, device=dev).expand(batch + (4, 4))
        poses: list[torch.Tensor] = []
        for spec in self._specs:
            parent_T = eye if spec.parent_index < 0 else poses[spec.parent_index]
            origin = torch.as_tensor(spec.origin, dtype=torch.float32, device=dev)
            T = parent_T @ origin
            if spec.joint_type != FIXED:
                q = qpos[..., spec.qpos_index] * spec.mimic_multiplier + spec.mimic_offset
                axis = torch.as_tensor(spec.axis, dtype=torch.float32, device=dev)
                if spec.joint_type == REVOLUTE:
                    J = torch.zeros(batch + (4, 4), dtype=torch.float32, device=dev)
                    J[..., :3, :3] = so3.exp(axis * q[..., None])
                    J[..., 3, 3] = 1.0
                    T = T @ J
                elif spec.joint_type == PRISMATIC:
                    shift = (T[..., :3, :3] @ axis) * q[..., None]
                    T = torch.cat(
                        [torch.cat([T[..., :3, :3], (T[..., :3, 3] + shift)[..., None]], -1),
                         T[..., 3:, :]],
                        dim=-2,
                    )
            poses.append(T)
        return torch.stack(poses, dim=-3)

    def fk_np(self, qpos: np.ndarray) -> np.ndarray:
        """Host-side numpy FK of one configuration [n_dof] -> [n_links, 4, 4]
        (float64 composition, float32 result), for data loading off-device."""
        qpos = np.asarray(qpos, dtype=np.float64)
        poses = np.zeros((self.n_links, 4, 4), dtype=np.float64)
        for i, spec in enumerate(self._specs):
            parent_T = np.eye(4) if spec.parent_index < 0 else poses[spec.parent_index]
            T = parent_T @ spec.origin.astype(np.float64)
            if spec.joint_type != FIXED:
                q = qpos[spec.qpos_index] * spec.mimic_multiplier + spec.mimic_offset
                if spec.joint_type == REVOLUTE:
                    w = spec.axis.astype(np.float64) * q
                    th = np.linalg.norm(w)
                    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
                    J = np.eye(4)
                    if th > 1e-12:
                        Kx = Kx / th
                        J[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
                    T = T @ J
                else:
                    T = T.copy()
                    T[:3, 3] += T[:3, :3] @ (spec.axis.astype(np.float64) * q)
            poses[i] = T
        return poses.astype(np.float32)


def build_chain(model: RobotModel, root: str | None = None) -> KinematicChain:
    """Build a KinematicChain from a parsed RobotModel.

    qpos ordering = document order of actuated (non-fixed, non-mimic)
    joints."""
    children: dict[str, list] = {}
    has_parent = set()
    for j in model.joints:
        children.setdefault(j.parent, []).append(j)
        has_parent.add(j.child)

    if root is None:
        roots = [l.name for l in model.links if l.name not in has_parent]
        if len(roots) != 1:
            raise ValueError(f"expected exactly 1 root link, found {roots}")
        root = roots[0]

    qpos_index = {j.name: i for i, j in enumerate(model.actuated_joints)}
    specs: list[_LinkSpec] = []

    def visit(link_name: str, parent_idx: int, joint) -> None:
        if joint is None:
            spec = _LinkSpec(
                link_name, -1, FIXED, np.eye(4, dtype=np.float32),
                np.zeros(3, dtype=np.float32), -1, 1.0, 0.0,
            )
        else:
            if joint.mimic_joint is not None:
                qi = qpos_index[joint.mimic_joint]
                mult, off = joint.mimic_multiplier, joint.mimic_offset
            elif joint.joint_type == FIXED:
                qi, mult, off = -1, 1.0, 0.0
            else:
                qi, mult, off = qpos_index[joint.name], 1.0, 0.0
            spec = _LinkSpec(
                link_name, parent_idx, joint.joint_type,
                joint.origin.astype(np.float32), joint.axis.astype(np.float32),
                qi, mult, off,
            )
        my_idx = len(specs)
        specs.append(spec)
        for j in children.get(link_name, []):
            visit(j.child, my_idx, j)

    visit(root, -1, None)
    return KinematicChain(
        specs,
        doc_order_names=model.link_names,
        n_dof=len(model.actuated_joints),
        limits=model.joint_limits,
    )


def _geometry_mesh(model: RobotModel, g: Geometry) -> TriMesh | None:
    if g.kind == "mesh":
        p = model.resolve_mesh_path(g.mesh_path)
        if not p.exists():
            return None
        m = load_mesh(p)
        if g.mesh_scale is not None:
            m = m.scaled(g.mesh_scale)
    elif g.kind == "box":
        m = make_box(tuple(g.size))
    elif g.kind == "cylinder":
        m = make_cylinder(g.radius, g.length)
    elif g.kind == "sphere":
        m = make_cylinder(g.radius, 2 * g.radius, sections=16)  # coarse proxy
    else:
        return None
    return m.transformed(g.origin)


def load_link_meshes(
    model: RobotModel, link_names: list[str] | None = None, collision: bool = False
) -> dict[str, TriMesh]:
    """Load and merge each link's visual (or collision) geometry, in link
    frame. Links whose meshes are missing on disk are skipped."""
    out: dict[str, TriMesh] = {}
    for link in model.links:
        if link_names is not None and link.name not in link_names:
            continue
        geoms = link.collisions if collision else link.visuals
        parts = [m for g in geoms if (m := _geometry_mesh(model, g)) is not None]
        if not parts:
            continue
        mesh = parts[0]
        for extra in parts[1:]:
            mesh = mesh.merged_with(extra)
        out[link.name] = mesh
    return out
