"""Scene3D — sequenced 3D debug recording to disk.

Torch-package copy of easyhec_tpu/utils/scene3d.py: ``add_robot`` poses the
links with the port's FK on the CPU.

Capability match for the reference's Vis3D wrapper
(easyhec/utils/vis3d_ext.py:27-650: per-step scene folders with point
clouds, meshes, boxes, cameras, images, lines, spheres, plus robot-specific
add_xarm/add_franka that FK-pose every link mesh). The reference records
into the wis3d viewer's folder format; here scenes are plain PLY + JSON + PNG
under `{out}/scenes/{step:05d}/` with a manifest — inspectable with any
point-cloud viewer and diffable in tests.

Rank-aware like the reference (vis3d_ext.py:48): only process 0 writes.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["Scene3D"]


def _write_ply(path: Path, verts: np.ndarray, faces: np.ndarray | None = None,
               colors: np.ndarray | None = None) -> None:
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    n = len(verts)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.ndim == 1:
            colors = np.tile(colors[None], (n, 1))
        colors = colors.astype(np.uint8)
    lines = ["ply", "format ascii 1.0", f"element vertex {n}",
             "property float x", "property float y", "property float z"]
    if has_color:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    nf = 0 if faces is None else len(faces)
    if faces is not None:
        lines += [f"element face {nf}", "property list uchar int vertex_indices"]
    lines += ["end_header"]
    body = []
    for i in range(n):
        row = f"{verts[i,0]} {verts[i,1]} {verts[i,2]}"
        if has_color:
            row += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
        body.append(row)
    if faces is not None:
        for f in np.asarray(faces, np.int64).reshape(-1, 3):
            body.append(f"3 {f[0]} {f[1]} {f[2]}")
    path.write_text("\n".join(lines + body) + "\n")


class Scene3D:
    """Per-step 3D scene recorder.

    >>> viz = Scene3D(out_dir, enable=cfg.dbg)
    >>> viz.set_scene_id(step)
    >>> viz.add_point_cloud(pts, name="workspace")
    >>> viz.add_robot(chain, renderer, link_idx, Tc_c2b, qpos)
    """

    def __init__(self, out_dir: str | Path, enable: bool = True, is_main: bool = True):
        self.enable = bool(enable and is_main)
        self.root = Path(out_dir) / "scenes"
        self.scene_id = 0
        self._counters: dict[str, int] = {}
        if self.enable:
            self.root.mkdir(parents=True, exist_ok=True)

    # -- sequencing (reference vis3d_ext.py:43-77) --------------------------
    def set_scene_id(self, scene_id: int) -> None:
        self.scene_id = int(scene_id)
        self._counters = {}

    def increase_scene_id(self) -> None:
        self.set_scene_id(self.scene_id + 1)

    def _dir(self) -> Path:
        d = self.root / f"{self.scene_id:05d}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _name(self, kind: str, name: str | None) -> str:
        i = self._counters.get(kind, 0)
        self._counters[kind] = i + 1
        return name or f"{kind}_{i}"

    def _manifest(self, entry: dict) -> None:
        path = self._dir() / "manifest.jsonl"
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    # -- adders --------------------------------------------------------------
    def add_point_cloud(self, points, colors=None, name: str | None = None) -> None:
        if not self.enable:
            return
        name = self._name("pointcloud", name)
        _write_ply(self._dir() / f"{name}.ply", np.asarray(points), colors=colors)
        self._manifest({"type": "point_cloud", "name": name, "file": f"{name}.ply"})

    def add_mesh(self, verts, faces, name: str | None = None, colors=None) -> None:
        if not self.enable:
            return
        name = self._name("mesh", name)
        _write_ply(self._dir() / f"{name}.ply", np.asarray(verts),
                   faces=np.asarray(faces), colors=colors)
        self._manifest({"type": "mesh", "name": name, "file": f"{name}.ply"})

    def add_boxes(self, centers, sizes, name: str | None = None) -> None:
        """Axis-aligned boxes as JSON (+ corner point cloud)."""
        if not self.enable:
            return
        name = self._name("boxes", name)
        centers = np.asarray(centers, np.float32).reshape(-1, 3)
        sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
        corners = []
        for c, s in zip(centers, sizes):
            for dx in (-0.5, 0.5):
                for dy in (-0.5, 0.5):
                    for dz in (-0.5, 0.5):
                        corners.append(c + s * np.array([dx, dy, dz]))
        _write_ply(self._dir() / f"{name}.ply", np.asarray(corners))
        self._manifest({
            "type": "boxes", "name": name, "file": f"{name}.ply",
            "centers": centers.tolist(), "sizes": sizes.tolist(),
        })

    def add_lines(self, starts, ends, name: str | None = None) -> None:
        if not self.enable:
            return
        name = self._name("lines", name)
        starts = np.asarray(starts, np.float32).reshape(-1, 3)
        ends = np.asarray(ends, np.float32).reshape(-1, 3)
        # polyline sampling for point-cloud viewers
        ts = np.linspace(0, 1, 16)[None, :, None]
        pts = starts[:, None] * (1 - ts) + ends[:, None] * ts
        _write_ply(self._dir() / f"{name}.ply", pts.reshape(-1, 3))
        self._manifest({
            "type": "lines", "name": name, "file": f"{name}.ply",
            "starts": starts.tolist(), "ends": ends.tolist(),
        })

    def add_spheres(self, centers, radii, name: str | None = None) -> None:
        if not self.enable:
            return
        name = self._name("spheres", name)
        centers = np.asarray(centers, np.float32).reshape(-1, 3)
        radii = np.asarray(radii, np.float32).reshape(-1)
        _write_ply(self._dir() / f"{name}.ply", centers)
        self._manifest({
            "type": "spheres", "name": name, "file": f"{name}.ply",
            "centers": centers.tolist(), "radii": radii.tolist(),
        })

    def add_camera(self, T_w2c: np.ndarray, K: np.ndarray | None = None,
                   name: str | None = None, scale: float = 0.1) -> None:
        """Camera pose as a frustum line set + JSON extrinsics."""
        if not self.enable:
            return
        name = self._name("camera", name)
        T = np.asarray(T_w2c, np.float32)
        Tinv = np.linalg.inv(T)
        c = Tinv[:3, 3]
        corners_cam = np.array(
            [[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32
        ) * scale / 2
        corners_w = corners_cam @ Tinv[:3, :3].T + c
        starts = np.concatenate([np.tile(c, (4, 1)), corners_w])
        ends = np.concatenate([corners_w, np.roll(corners_w, 1, axis=0)])
        self.add_lines(starts, ends, name=name)
        entry = {"type": "camera", "name": name, "T_w2c": T.tolist()}
        if K is not None:
            entry["K"] = np.asarray(K).tolist()
        self._manifest(entry)

    def add_image(self, img, name: str | None = None) -> None:
        if not self.enable:
            return
        from .imaging import save_image

        name = self._name("image", name)
        save_image(self._dir() / f"{name}.png", np.asarray(img))
        self._manifest({"type": "image", "name": name, "file": f"{name}.png"})

    def add_robot(self, chain, renderer, link_indices, T_base, qpos,
                  name: str | None = None) -> None:
        """FK-pose every link mesh and record the posed robot as one mesh
        (the reference's add_xarm/add_franka, vis3d_ext.py:532-646) —
        works for ANY chain rather than two hard-coded robots."""
        if not self.enable:
            return
        import torch

        name = self._name("robot", name)
        q = torch.as_tensor(np.asarray(qpos), dtype=torch.float32)
        lp = chain.fk(q).numpy()[np.asarray(link_indices)]
        T_base = np.asarray(T_base, np.float32)
        verts_all, faces_all, off = [], [], 0
        for li in range(lp.shape[0]):
            v = np.asarray(renderer.link_vertices(li), np.float32)
            f = np.asarray(renderer.link_faces(li), np.int64)
            T = T_base @ lp[li]
            verts_all.append(v @ T[:3, :3].T + T[:3, 3])
            faces_all.append(f + off)
            off += len(v)
        _write_ply(self._dir() / f"{name}.ply",
                   np.concatenate(verts_all), faces=np.concatenate(faces_all))
        self._manifest({"type": "robot", "name": name, "file": f"{name}.ply",
                        "qpos": np.asarray(qpos).tolist()})
