"""First-party URDF parser.

Replaces the reference's dependence on SAPIEN's C++ URDF loader + Pinocchio
FK (reference: easyhec/structures/sapien_kin.py:5-35) with a dependency-free
XML parse into plain dataclasses. The kinematic math lives in
`easyhec_torch.robot.kinematics` as a batched torch function.

This module is a numpy copy of easyhec_tpu/robot/urdf.py, kept so the port
imports nothing of the JAX package.

Conventions:
- Joint origin rpy is fixed-axis XYZ (roll-pitch-yaw): R = Rz(y) @ Ry(p) @ Rx(r).
- Links are indexed in URDF document order (matching how SAPIEN articulations
  expose link indices, which the reference's datasets use via
  `cfg.dataset.xarm_real.use_links`).
- Actuated joints (revolute/continuous/prismatic) are ordered by document
  order; `qpos` follows that order.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["Geometry", "Joint", "Link", "RobotModel", "parse_urdf", "rpy_to_matrix"]

FIXED, REVOLUTE, PRISMATIC = 0, 1, 2
_JOINT_TYPES = {
    "fixed": FIXED,
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
    # planar/floating are not used by any target robot; reject explicitly.
}


def rpy_to_matrix(rpy) -> np.ndarray:
    r, p, y = [float(v) for v in rpy]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _origin_to_T(el) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    if el is None:
        return T
    xyz = el.get("xyz", "0 0 0").split()
    rpy = el.get("rpy", "0 0 0").split()
    T[:3, :3] = rpy_to_matrix(rpy)
    T[:3, 3] = [float(v) for v in xyz]
    return T


@dataclass
class Geometry:
    """One <visual> or <collision> geometry element of a link."""

    origin: np.ndarray  # [4,4] link-frame transform of the geometry
    kind: str  # "mesh" | "box" | "cylinder" | "sphere"
    mesh_path: str | None = None
    mesh_scale: np.ndarray | None = None  # [3]
    size: np.ndarray | None = None  # box extents [3]
    radius: float | None = None  # cylinder/sphere
    length: float | None = None  # cylinder


@dataclass
class Joint:
    name: str
    joint_type: int  # FIXED | REVOLUTE | PRISMATIC
    parent: str
    child: str
    origin: np.ndarray  # [4,4] parent-link frame -> joint frame
    axis: np.ndarray  # [3] in joint frame
    lower: float = 0.0
    upper: float = 0.0
    velocity: float = 0.0
    effort: float = 0.0
    mimic_joint: str | None = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0


@dataclass
class Link:
    name: str
    visuals: list[Geometry] = field(default_factory=list)
    collisions: list[Geometry] = field(default_factory=list)


@dataclass
class RobotModel:
    name: str
    links: list[Link]
    joints: list[Joint]
    mesh_dir: Path  # base dir for resolving relative mesh paths

    def link_index(self, name: str) -> int:
        for i, l in enumerate(self.links):
            if l.name == name:
                return i
        raise KeyError(f"no link named {name!r}")

    @property
    def link_names(self) -> list[str]:
        return [l.name for l in self.links]

    @property
    def actuated_joints(self) -> list[Joint]:
        return [
            j
            for j in self.joints
            if j.joint_type != FIXED and j.mimic_joint is None
        ]

    @property
    def joint_limits(self) -> np.ndarray:
        """[n_dof, 2] lower/upper for actuated joints."""
        return np.array(
            [[j.lower, j.upper] for j in self.actuated_joints], dtype=np.float32
        )

    def resolve_mesh_path(self, mesh_path: str) -> Path:
        p = mesh_path
        if p.startswith("package://"):
            p = p[len("package://") :]
            # package://<pkg>/rest — try stripping the package component too
            candidate = self.mesh_dir / p
            if not candidate.exists() and "/" in p:
                candidate = self.mesh_dir / p.split("/", 1)[1]
            return candidate
        if p.startswith("file://"):
            return Path(p[len("file://") :])
        return self.mesh_dir / p


def _parse_geometry(el, q) -> Geometry | None:
    geo = el.find("geometry")
    if geo is None:
        return None
    origin = _origin_to_T(el.find("origin"))
    mesh = geo.find("mesh")
    if mesh is not None:
        scale = mesh.get("scale")
        return Geometry(
            origin=origin,
            kind="mesh",
            mesh_path=mesh.get("filename"),
            mesh_scale=(
                np.array(scale.split(), dtype=np.float32) if scale else None
            ),
        )
    box = geo.find("box")
    if box is not None:
        return Geometry(
            origin=origin,
            kind="box",
            size=np.array(box.get("size", "1 1 1").split(), dtype=np.float32),
        )
    cyl = geo.find("cylinder")
    if cyl is not None:
        return Geometry(
            origin=origin,
            kind="cylinder",
            radius=float(cyl.get("radius", 0.0)),
            length=float(cyl.get("length", 0.0)),
        )
    sph = geo.find("sphere")
    if sph is not None:
        return Geometry(origin=origin, kind="sphere", radius=float(sph.get("radius", 0.0)))
    return None


def parse_urdf(path: str | Path) -> RobotModel:
    path = Path(path).expanduser()
    root = ET.parse(path).getroot()
    if root.tag != "robot":
        raise ValueError(f"{path}: root element is <{root.tag}>, expected <robot>")

    links: list[Link] = []
    for link_el in root.findall("link"):
        link = Link(name=link_el.get("name"))
        for vis in link_el.findall("visual"):
            g = _parse_geometry(vis, None)
            if g is not None:
                link.visuals.append(g)
        for col in link_el.findall("collision"):
            g = _parse_geometry(col, None)
            if g is not None:
                link.collisions.append(g)
        links.append(link)

    joints: list[Joint] = []
    for j_el in root.findall("joint"):
        jtype_str = j_el.get("type")
        if jtype_str not in _JOINT_TYPES:
            raise ValueError(f"unsupported joint type {jtype_str!r} in {path}")
        axis_el = j_el.find("axis")
        axis = np.array(
            (axis_el.get("xyz", "1 0 0") if axis_el is not None else "1 0 0").split(),
            dtype=np.float32,
        )
        n = np.linalg.norm(axis)
        if n > 0:
            axis = axis / n
        limit_el = j_el.find("limit")
        mimic_el = j_el.find("mimic")
        joints.append(
            Joint(
                name=j_el.get("name"),
                joint_type=_JOINT_TYPES[jtype_str],
                parent=j_el.find("parent").get("link"),
                child=j_el.find("child").get("link"),
                origin=_origin_to_T(j_el.find("origin")),
                axis=axis,
                lower=float(limit_el.get("lower", 0.0)) if limit_el is not None else (-np.pi if jtype_str == "continuous" else 0.0),
                upper=float(limit_el.get("upper", 0.0)) if limit_el is not None else (np.pi if jtype_str == "continuous" else 0.0),
                velocity=float(limit_el.get("velocity", 0.0)) if limit_el is not None else 0.0,
                effort=float(limit_el.get("effort", 0.0)) if limit_el is not None else 0.0,
                mimic_joint=mimic_el.get("joint") if mimic_el is not None else None,
                mimic_multiplier=float(mimic_el.get("multiplier", 1.0)) if mimic_el is not None else 1.0,
                mimic_offset=float(mimic_el.get("offset", 0.0)) if mimic_el is not None else 0.0,
            )
        )

    return RobotModel(
        name=root.get("name", path.stem),
        links=links,
        joints=joints,
        mesh_dir=path.parent,
    )
