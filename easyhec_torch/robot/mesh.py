"""First-party triangle-mesh loading and packing.

The reference leans on `trimesh` for mesh IO (reference:
easyhec/modeling/models/rb_solve/rb_solver.py:23-28) and pytorch3d `Meshes`
for packing (reference: easyhec/utils/render_api.py:70-96). Here both are
first-party: minimal, dependency-free loaders for the formats the robot
assets actually use (binary/ASCII STL, OBJ, COLLADA .dae, binary glTF .glb)
plus static padded packing (fixed shapes, per-face link ids, no ragged
structures). A numpy copy of easyhec_tpu/robot/mesh.py, kept so the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

def _parse_nums(text: str, dtype) -> "np.ndarray":
    """Whitespace-separated numbers -> array (np.fromstring is deprecated)."""
    return np.array(text.split(), dtype=dtype)


__all__ = ["TriMesh", "load_mesh", "pack_meshes", "PackedMesh", "make_box", "make_cylinder"]


@dataclass
class TriMesh:
    """Host-side triangle mesh: vertices [N,3] f32, faces [M,3] i32."""

    vertices: np.ndarray
    faces: np.ndarray

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    def transformed(self, T: np.ndarray) -> "TriMesh":
        R, t = np.asarray(T)[:3, :3], np.asarray(T)[:3, 3]
        return TriMesh(self.vertices @ R.T + t, self.faces)

    def scaled(self, s) -> "TriMesh":
        return TriMesh(self.vertices * np.asarray(s, dtype=np.float32), self.faces)

    def merged_with(self, other: "TriMesh") -> "TriMesh":
        return TriMesh(
            np.concatenate([self.vertices, other.vertices]),
            np.concatenate([self.faces, other.faces + self.n_vertices]),
        )

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(0), self.vertices.max(0)


# ---------------------------------------------------------------- STL


def _load_stl(path: Path) -> TriMesh:
    data = path.read_bytes()
    # ASCII STL starts with "solid" AND contains "facet"; binary may also start
    # with "solid" in the 80-byte header, so check for facet keywords.
    head = data[:512].lower()
    if head.lstrip().startswith(b"solid") and b"facet" in head:
        return _load_stl_ascii(data)
    return _load_stl_binary(data)


def _load_stl_binary(data: bytes) -> TriMesh:
    (n_tri,) = struct.unpack_from("<I", data, 80)
    if 84 + 50 * n_tri > len(data):
        raise ValueError("corrupt binary STL: triangle count exceeds file size")
    raw = np.frombuffer(data, dtype=np.uint8, count=50 * n_tri, offset=84)
    rec = raw.reshape(n_tri, 50)
    # Each record: normal(12B) + 3 vertices(36B) + attribute(2B)
    tri_verts = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    return _weld(tri_verts)


def _load_stl_ascii(data: bytes) -> TriMesh:
    verts = []
    for line in data.decode("ascii", errors="replace").splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    tri_verts = np.asarray(verts, dtype=np.float32).reshape(-1, 3, 3)
    return _weld(tri_verts)


def _weld(tri_verts: np.ndarray) -> TriMesh:
    """Deduplicate per-triangle vertex soup into indexed vertices + faces."""
    flat = tri_verts.reshape(-1, 3)
    uniq, inv = np.unique(flat.view([("", flat.dtype)] * 3), return_inverse=True)
    vertices = uniq.view(flat.dtype).reshape(-1, 3)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces (repeated indices)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return TriMesh(vertices, faces[ok])


# ---------------------------------------------------------------- OBJ


def _load_obj(path: Path) -> TriMesh:
    verts, faces = [], []
    for line in path.read_text(errors="replace").splitlines():
        if line.startswith("v "):
            p = line.split()
            verts.append([float(p[1]), float(p[2]), float(p[3])])
        elif line.startswith("f "):
            idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
            idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
            for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


# ---------------------------------------------------------------- COLLADA (.dae)


def _load_dae(path: Path) -> TriMesh:
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    root = tree.getroot()
    ns = {"c": root.tag.split("}")[0].strip("{")} if "}" in root.tag else {"c": ""}

    def q(tag):
        return f"{{{ns['c']}}}{tag}" if ns["c"] else tag

    # Unit scale and up-axis
    scale = 1.0
    up = "Z_UP"
    asset = root.find(q("asset"))
    if asset is not None:
        unit = asset.find(q("unit"))
        if unit is not None and unit.get("meter"):
            scale = float(unit.get("meter"))
        up_el = asset.find(q("up_axis"))
        if up_el is not None and up_el.text:
            up = up_el.text.strip()

    # Parse all geometries -> dict id -> TriMesh
    geoms: dict[str, TriMesh] = {}
    for geom in root.iter(q("geometry")):
        mesh_el = geom.find(q("mesh"))
        if mesh_el is None:
            continue
        sources = {}
        for src in mesh_el.findall(q("source")):
            arr = src.find(q("float_array"))
            if arr is not None and arr.text:
                sources["#" + src.get("id")] = _parse_nums(arr.text, np.float32)
        vertices_el = mesh_el.find(q("vertices"))
        vert_source = None
        if vertices_el is not None:
            for inp in vertices_el.findall(q("input")):
                if inp.get("semantic") == "POSITION":
                    vert_source = inp.get("source")
            vert_id = "#" + vertices_el.get("id")
        parts = []
        for prim in list(mesh_el.findall(q("triangles"))) + list(mesh_el.findall(q("polylist"))):
            inputs = prim.findall(q("input"))
            stride = 1 + max((int(i.get("offset", 0)) for i in inputs), default=0)
            v_offset = 0
            for i in inputs:
                if i.get("semantic") == "VERTEX":
                    v_offset = int(i.get("offset", 0))
            p_el = prim.find(q("p"))
            if p_el is None or not p_el.text:
                continue
            p = _parse_nums(p_el.text, np.int64)
            v_idx = p.reshape(-1, stride)[:, v_offset]
            if prim.tag == q("polylist"):
                vcount = _parse_nums(prim.find(q("vcount")).text, np.int64)
                tris = []
                pos = 0
                for n in vcount:
                    poly = v_idx[pos : pos + n]
                    for k in range(1, n - 1):
                        tris.append([poly[0], poly[k], poly[k + 1]])
                    pos += n
                faces = np.asarray(tris, dtype=np.int32)
            else:
                faces = v_idx.reshape(-1, 3).astype(np.int32)
            if vert_source and vert_source in sources:
                verts = sources[vert_source].reshape(-1, 3)
            else:
                verts = next(iter(sources.values())).reshape(-1, 3)
            parts.append(TriMesh(verts, faces))
        if parts:
            m = parts[0]
            for extra in parts[1:]:
                m = m.merged_with(extra)
            geoms["#" + geom.get("id")] = m

    # Walk the visual scene applying node transforms
    def node_matrix(node) -> np.ndarray:
        M = np.eye(4, dtype=np.float32)
        for child in node:
            if child.tag == q("matrix") and child.text:
                M = M @ _parse_nums(child.text, np.float32).reshape(4, 4)
            elif child.tag == q("translate") and child.text:
                t = _parse_nums(child.text, np.float32)
                T = np.eye(4, dtype=np.float32)
                T[:3, 3] = t
                M = M @ T
            elif child.tag == q("rotate") and child.text:
                x, y, z, deg = _parse_nums(child.text, np.float32)
                a = np.deg2rad(deg)
                axis = np.array([x, y, z], dtype=np.float32)
                n = np.linalg.norm(axis)
                if n > 0:
                    axis /= n
                    K = np.array(
                        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]],
                        dtype=np.float32,
                    )
                    R = np.eye(3, dtype=np.float32) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
                    T = np.eye(4, dtype=np.float32)
                    T[:3, :3] = R
                    M = M @ T
            elif child.tag == q("scale") and child.text:
                s = _parse_nums(child.text, np.float32)
                T = np.diag(np.array([s[0], s[1], s[2], 1.0], dtype=np.float32))
                M = M @ T
        return M

    collected: list[TriMesh] = []

    def visit(node, parent_T):
        T = parent_T @ node_matrix(node)
        for inst in node.findall(q("instance_geometry")):
            url = inst.get("url")
            if url in geoms:
                collected.append(geoms[url].transformed(T))
        for child in node.findall(q("node")):
            visit(child, T)

    scene = root.find(q("library_visual_scenes"))
    if scene is not None:
        for vs in scene.findall(q("visual_scene")):
            for node in vs.findall(q("node")):
                visit(node, np.eye(4, dtype=np.float32))
    if not collected:  # no scene graph — take all geometries raw
        collected = list(geoms.values())

    mesh = collected[0]
    for extra in collected[1:]:
        mesh = mesh.merged_with(extra)
    if scale != 1.0:
        mesh = mesh.scaled(scale)
    if up == "Y_UP":  # rotate so +Z is up (URDF convention)
        Rx = np.array(
            [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
        )
        mesh = mesh.transformed(Rx)
    return mesh


# ---------------------------------------------------------------- glTF binary (.glb)

_GLTF_CTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(path: Path) -> TriMesh:
    data = path.read_bytes()
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError(f"not a GLB file: {path}")
    offset = 12
    gltf = None
    bin_chunk = b""
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            gltf = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
        offset += 8 + chunk_len + (-chunk_len) % 4

    def read_accessor(idx: int) -> np.ndarray:
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dtype = _GLTF_CTYPE[acc["componentType"]]
        ncomp = _GLTF_NCOMP[acc["type"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or ncomp * np.dtype(dtype).itemsize
        count = acc["count"]
        if stride == ncomp * np.dtype(dtype).itemsize:
            out = np.frombuffer(bin_chunk, dtype=dtype, count=count * ncomp, offset=start)
            return out.reshape(count, ncomp)
        rows = np.frombuffer(
            bin_chunk, dtype=np.uint8, count=stride * count, offset=start
        ).reshape(count, stride)
        return rows[:, : ncomp * np.dtype(dtype).itemsize].copy().view(dtype)

    def node_T(node) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        T = np.eye(4, dtype=np.float32)
        if "rotation" in node:  # quaternion xyzw
            x, y, z, w = node["rotation"]
            R = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ],
                dtype=np.float32,
            )
            T[:3, :3] = R
        if "scale" in node:
            T[:3, :3] = T[:3, :3] @ np.diag(np.asarray(node["scale"], np.float32))
        if "translation" in node:
            T[:3, 3] = node["translation"]
        return T

    meshes_out: list[TriMesh] = []

    def collect_mesh(mesh_idx: int, T: np.ndarray):
        for prim in gltf["meshes"][mesh_idx]["primitives"]:
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            verts = read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
            if "indices" in prim:
                faces = read_accessor(prim["indices"]).reshape(-1, 3).astype(np.int32)
            else:
                faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
            meshes_out.append(TriMesh(verts, faces).transformed(T))

    def visit(node_idx: int, parent_T: np.ndarray):
        node = gltf["nodes"][node_idx]
        T = parent_T @ node_T(node)
        if "mesh" in node:
            collect_mesh(node["mesh"], T)
        for child in node.get("children", []):
            visit(child, T)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    # glTF is Y-up; URDF/robotics is Z-up: rotate +90deg about X.
    y2z = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    for node_idx in scene.get("nodes", range(len(gltf.get("nodes", [])))):
        visit(node_idx, y2z)
    if not meshes_out:
        raise ValueError(f"no triangle primitives in {path}")
    mesh = meshes_out[0]
    for extra in meshes_out[1:]:
        mesh = mesh.merged_with(extra)
    return mesh


# ---------------------------------------------------------------- dispatch


def load_mesh(path: str | Path) -> TriMesh:
    path = Path(path).expanduser()
    suffix = path.suffix.lower()
    if suffix == ".stl":
        return _load_stl(path)
    if suffix == ".obj":
        return _load_obj(path)
    if suffix == ".dae":
        return _load_dae(path)
    if suffix == ".glb":
        return _load_glb(path)
    if suffix == ".ply":
        return _load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


# ---------------------------------------------------------------- PLY (ascii + binary_little_endian)


def _load_ply(path: Path) -> TriMesh:
    data = path.read_bytes()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]
    fmt = "ascii"
    elements = []  # (name, count, [(type, prop)...])
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    _PLY_T = {
        "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
        "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
        "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    }
    verts, faces = None, None
    if fmt == "ascii":
        lines = body.decode("ascii", errors="replace").split("\n")
        pos = 0
        for name, count, props in elements:
            rows = lines[pos : pos + count]
            pos += count
            if name == "vertex":
                arr = np.array([[float(v) for v in r.split()[:3]] for r in rows], np.float32)
                verts = arr
            elif name == "face":
                tris = []
                for r in rows:
                    vals = [int(v) for v in r.split()]
                    n, idx = vals[0], vals[1:]
                    for k in range(1, n - 1):
                        tris.append([idx[0], idx[k], idx[k + 1]])
                faces = np.asarray(tris, np.int32)
    else:
        off = 0
        le = "<" if "little" in fmt else ">"
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(f"p{i}", le + _PLY_T[p[1]]) for i, p in enumerate(props)])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack(
                    [arr["p0"], arr["p1"], arr["p2"]], axis=-1
                ).astype(np.float32)
            elif name == "face":
                # Assume single list property (vertex_indices)
                lp = props[0]
                cnt_t = np.dtype(le + _PLY_T[lp[1]])
                idx_t = np.dtype(le + _PLY_T[lp[2]])
                tris = []
                for _ in range(count):
                    n = int(np.frombuffer(body, dtype=cnt_t, count=1, offset=off)[0])
                    off += cnt_t.itemsize
                    idx = np.frombuffer(body, dtype=idx_t, count=n, offset=off)
                    off += idx_t.itemsize * n
                    for k in range(1, n - 1):
                        tris.append([idx[0], idx[k], idx[k + 1]])
                faces = np.asarray(tris, np.int32)
            else:  # skip unknown fixed-size element
                dt = np.dtype([(f"p{i}", le + _PLY_T[p[1]]) for i, p in enumerate(props) if p[0] == "scalar"])
                off += dt.itemsize * count
    if verts is None:
        raise ValueError(f"no vertex element in {path}")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return TriMesh(verts, faces)


# ---------------------------------------------------------------- procedural meshes (test fixtures)


def make_box(extents=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> TriMesh:
    ex, ey, ez = [e / 2 for e in extents]
    cx, cy, cz = center
    v = np.array(
        [
            [-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
            [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez],
        ],
        np.float32,
    ) + np.asarray([cx, cy, cz], np.float32)
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom (z-)
            [4, 5, 6], [4, 6, 7],  # top (z+)
            [0, 1, 5], [0, 5, 4],  # y-
            [2, 3, 7], [2, 7, 6],  # y+
            [1, 2, 6], [1, 6, 5],  # x+
            [3, 0, 4], [3, 4, 7],  # x-
        ],
        np.int32,
    )
    return TriMesh(v, f)


def make_cylinder(radius=0.5, height=1.0, sections=24) -> TriMesh:
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
        f += [[i, j, sections + i], [j, sections + j, sections + i]]  # side
        f += [[cb, j, i], [ct, sections + i, sections + j]]  # caps
    return TriMesh(v, np.asarray(f, np.int32))


# ---------------------------------------------------------------- packing


@dataclass
class PackedMesh:
    """Multiple meshes packed into flat arrays for batched rendering.

    vertices: [V, 3] f32 — all vertices concatenated
    faces:    [F, 3] i32 — indices into the packed vertex array
    face_mesh_id: [F] i32 — which source mesh (≈ robot link) each face is from
    vert_mesh_id: [V] i32 — which source mesh each vertex is from
    """

    vertices: np.ndarray
    faces: np.ndarray
    face_mesh_id: np.ndarray
    vert_mesh_id: np.ndarray
    n_meshes: int


def pack_meshes(meshes: list[TriMesh]) -> PackedMesh:
    verts, faces, f_id, v_id = [], [], [], []
    v_off = 0
    for i, m in enumerate(meshes):
        verts.append(m.vertices)
        faces.append(m.faces + v_off)
        f_id.append(np.full(m.n_faces, i, np.int32))
        v_id.append(np.full(m.n_vertices, i, np.int32))
        v_off += m.n_vertices
    return PackedMesh(
        vertices=np.concatenate(verts),
        faces=np.concatenate(faces),
        face_mesh_id=np.concatenate(f_id),
        vert_mesh_id=np.concatenate(v_id),
        n_meshes=len(meshes),
    )


def decimate_vertex_clustering(mesh: TriMesh, voxel: float) -> TriMesh:
    """Vertex-clustering decimation: snap vertices to a voxel grid, weld,
    drop degenerate faces. Crude but ideal for silhouette rendering (the
    silhouette is insensitive to sub-voxel surface detail), and it slashes
    the per-tile triangle counts that bound rasterizer work."""
    if voxel <= 0:
        return mesh
    keys = np.floor(mesh.vertices / voxel).astype(np.int64)
    # Unique voxel per vertex -> representative = mean of cluster
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    reps = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(reps, inv, mesh.vertices.astype(np.float64))
    np.add.at(counts, inv, 1)
    reps = (reps / counts[:, None]).astype(np.float32)
    faces = inv[mesh.faces]
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return TriMesh(reps, faces[ok].astype(np.int32))


def subdivide_to_max_edge(mesh: TriMesh, max_edge: float, max_passes: int = 12) -> TriMesh:
    """Split triangles until every edge is shorter than max_edge (meters).

    CAD meshes mix tiny fillet triangles with huge flat plates; the huge ones
    blow past the rasterizer's static tile-rect window (TileConfig.rect_y/x)
    and concentrate bin occupancy. Longest-edge midpoint bisection normalizes
    triangle size with zero geometric change (splits don't move the surface;
    the soft-coverage union is T-junction tolerant because interior seams are
    covered from both sides). Run AFTER decimation.
    """
    if max_edge <= 0:
        return mesh
    verts = np.asarray(mesh.vertices, np.float64)
    faces = np.asarray(mesh.faces, np.int64)
    for _ in range(max_passes):
        tri = verts[faces]  # [F, 3, 3]
        e = np.stack(
            [
                np.linalg.norm(tri[:, 1] - tri[:, 0], axis=1),
                np.linalg.norm(tri[:, 2] - tri[:, 1], axis=1),
                np.linalg.norm(tri[:, 0] - tri[:, 2], axis=1),
            ],
            axis=1,
        )  # edge i is (v_i, v_{i+1})
        longest = e.argmax(axis=1)
        needs = e.max(axis=1) > max_edge
        if not needs.any():
            break
        keep = faces[~needs]
        split = faces[needs]
        li = longest[needs]
        a = split[np.arange(len(split)), li]
        b = split[np.arange(len(split)), (li + 1) % 3]
        c = split[np.arange(len(split)), (li + 2) % 3]
        # Weld shared midpoints so both sides of an edge split identically.
        key = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
        uk, inv = np.unique(key, axis=0, return_inverse=True)
        mids = (verts[uk[:, 0]] + verts[uk[:, 1]]) * 0.5
        m = len(verts) + inv
        verts = np.concatenate([verts, mids])
        f1 = np.stack([a, m, c], axis=1)
        f2 = np.stack([m, b, c], axis=1)
        faces = np.concatenate([keep, f1, f2])
    return TriMesh(verts.astype(np.float32), faces.astype(np.int32))
