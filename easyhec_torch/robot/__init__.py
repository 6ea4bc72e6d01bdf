from .kinematics import KinematicChain, build_chain, load_link_meshes
from .mesh import PackedMesh, TriMesh, load_mesh, make_box, make_cylinder, pack_meshes
from .urdf import RobotModel, parse_urdf

__all__ = [
    "KinematicChain",
    "build_chain",
    "load_link_meshes",
    "PackedMesh",
    "TriMesh",
    "load_mesh",
    "make_box",
    "make_cylinder",
    "pack_meshes",
    "RobotModel",
    "parse_urdf",
]
