"""High-level robot renderer: static mesh arrays, silhouettes and depth.

Torch counterpart of easyhec_tpu/render/renderer.py::RobotRenderer. All
links of all frames render in one batched call:

- the fused route (``tile.fused``): ``bin_state`` packs dense or compact
  base-frame records, ``silhouette`` runs the dense silhouette kernels (K4),
  differentiable in Tc_c2b;
- the unfused route (``tile.fused=False``): ``silhouette`` sets up the
  triangles, bins them (counting sort, or top-k with ``binner="topk"``),
  packs tile-local edge records and rasterizes them with K5, differentiable
  through the record pack and the triangle setup; ``bin_state`` returns a
  detached ``BinState`` to reuse across steps;
- ``depth`` (hard z and link ids, plain PyTorch) and ``link_silhouettes``
  (one render per link).

Two options of the JAX package's config run without any kernel, in plain
PyTorch, and only when asked for: ``mode="brute"`` (every pixel against
every triangle, render/raster_jnp.py) and ``tile.use_pallas=False`` (the
plain-tensor tiled rasterizer, tiled._silhouette_tiled_single). On either,
the fused gates fall through to the stateless routes as in the JAX
package: ``bin_state`` returns the counting binner's state and
``silhouette`` renders without it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..robot.mesh import TriMesh, pack_meshes
from .projection import setup_triangles, setup_triangles_corners, transform_verts
from .raster_jnp import depth_bruteforce, silhouette_bruteforce
from .tiled import TileConfig, depth_tiled, silhouette_tiled

__all__ = ["RobotRenderer"]


class RobotRenderer:
    """Renders a set of per-link meshes under per-frame link poses.

    Static data is baked at construction onto ``device`` (None = CUDA; the
    constructor raises when CUDA is absent unless ``device="cpu"``).

    mode: "tiled" (the binned routes) or "brute" (the dense reference).
    """

    def __init__(
        self,
        link_meshes: list[TriMesh],
        H: int,
        W: int,
        tile: TileConfig | None = None,
        mode: str = "tiled",
        device=None,
    ):
        if mode not in ("tiled", "brute"):
            raise ValueError(f"unknown render mode {mode!r} (tiled | brute)")
        self.device = resolve_device(device)
        packed = pack_meshes(link_meshes)
        self.meshes = list(link_meshes)
        self.n_links = packed.n_meshes
        self.H, self.W = int(H), int(W)
        self.tile = tile or TileConfig()
        self.mode = mode
        self.vertices = torch.as_tensor(packed.vertices, dtype=torch.float32,
                                        device=self.device)  # [V, 3]
        self.faces = torch.as_tensor(packed.faces, device=self.device)  # [F, 3]
        self.vert_link_id = torch.as_tensor(packed.vert_mesh_id, device=self.device)
        self.face_link_id = torch.as_tensor(packed.face_mesh_id, device=self.device)
        # Static face-corner expansion (projection.setup_triangles_corners).
        vc = packed.vertices[packed.faces]  # [F, 3, 3]
        hom = np.concatenate([vc, np.ones_like(vc[..., :1])], axis=-1)
        self.corners_rest = torch.as_tensor(
            np.ascontiguousarray(hom.transpose(1, 2, 0)), dtype=torch.float32,
            device=self.device,
        )  # [3 corners, 4, F]
        onehot = packed.face_mesh_id[None, :] == np.arange(packed.n_meshes)[:, None]
        self.face_link_onehot = torch.as_tensor(
            onehot, dtype=torch.float32, device=self.device
        )  # [L, F]
        # Per-link AABB corners in the link frame [L, 8, 3]: the drift probe
        # set of adaptive rebinning (models.calib.drift_probe_points).
        corners = np.zeros((packed.n_meshes, 8, 3), np.float32)
        cube = np.array(
            [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.float32
        )
        for l in range(packed.n_meshes):
            v = packed.vertices[packed.vert_mesh_id == l]
            if len(v) == 0:
                continue
            lo, hi = v.min(0), v.max(0)
            corners[l] = lo + cube * (hi - lo)
        self._link_aabb_corners = corners

    @property
    def n_faces(self) -> int:
        return self.corners_rest.shape[-1]

    def link_aabb_corners(self) -> np.ndarray:
        """[L, 8, 3] per-link mesh AABB corners in the link frame (host numpy;
        empty links give 8 zero corners = the link origin)."""
        return self._link_aabb_corners

    def link_vertices(self, link: int) -> np.ndarray:
        """Vertices of one link's mesh [Nv, 3] (host numpy)."""
        v = self.vertices.cpu().numpy()
        return v[self.vert_link_id.cpu().numpy() == link]

    def link_faces(self, link: int) -> np.ndarray:
        """Faces of one link's mesh, re-indexed into link_vertices."""
        vid = self.vert_link_id.cpu().numpy()
        faces = self.faces.cpu().numpy()[self.face_link_id.cpu().numpy() == link]
        offset = int(np.flatnonzero(vid == link)[0]) if np.any(vid == link) else 0
        return faces - offset

    def camera_link_poses(self, Tc_c2b: torch.Tensor, link_poses: torch.Tensor):
        """Camera-from-link transforms: Tc_c2b [..., 4, 4] camera-from-base,
        link_poses [..., L, 4, 4] base-from-link -> [..., L, 4, 4]."""
        return torch.einsum("...ij,...ljk->...lik", Tc_c2b, link_poses)

    def _triangles(self, Tc_c2l, K):
        """AoS screen triangles (Triangles2D) of the packed vertices."""
        return setup_triangles(transform_verts(self.vertices, self.vert_link_id, Tc_c2l),
                               self.faces, K)

    def _triangles_soa(self, Tc_c2l, K):
        """SoA screen triangles from the static face corners."""
        return setup_triangles_corners(self.corners_rest, self.face_link_onehot, Tc_c2l,
                                       K, cull_backfaces=self.tile.cull_backfaces)

    @property
    def kernel_route(self) -> bool:
        """Whether this renderer draws through the kernels: the tiled mode on
        the kernel binners (False for mode="brute" and tile.use_pallas=False,
        which render in plain PyTorch)."""
        return self.mode == "tiled" and self.tile.use_pallas

    def _fused(self) -> bool:
        """Whether the fused states and kernels serve this renderer."""
        return self.kernel_route and self.tile.fused

    def bin_state(self, Tc_c2b, link_poses, K, sharpness: float = 1.0):
        """Rebin state for the current pose (leaves carry the flattened frame
        batch); reuse it while the pose stays within tile.margin px of where
        it was built. Fused route: a CompactState when tile.compact_chunks >
        0, else a FusedState (sharpness must match the loss kernel's when
        tile.bwd_chunks > 0). Otherwise the counting binner's BinState,
        detached."""
        if self._fused():
            from .fused import build_compact_state, build_fused_state

            if self.tile.compact_chunks > 0:
                return build_compact_state(self, Tc_c2b, link_poses, K,
                                           sharpness=sharpness)
            return build_fused_state(self, Tc_c2b, link_poses, K)
        from .binning import fields_and_bins

        with torch.no_grad():
            tris = self._triangles_soa(self.camera_link_poses(Tc_c2b, link_poses), K)
            batch = tris.valid.shape[:-1]
            n = math.prod(batch)
            flat = type(tris)(*(a.reshape((n,) + a.shape[len(batch):]) for a in tris))
            _, state = fields_and_bins(flat, self.H, self.W, self.tile)
        return state

    def silhouette(self, Tc_c2b, link_poses, K, sharpness: float = 1.0,
                   bin_state=None):
        """Soft silhouette of the whole arm (union of links) in [0, 1]:
        Tc_c2b [..., 4, 4], link_poses [..., L, 4, 4], K [3, 3] -> [..., H, W].

        Fused route: differentiable in Tc_c2b; bin_state an optional
        FusedState (a CompactState drives the loss only, so it is dropped and
        the bins are rebuilt densely). Unfused route: differentiable in
        Tc_c2b and link_poses through K5; bin_state an optional BinState
        (from self.bin_state) to reuse the bins across optimizer steps.
        ``mode="brute"`` and ``use_pallas=False``: differentiable in both,
        plain PyTorch, bin_state ignored."""
        if self._fused():
            from .fused import CompactState, silhouette_fused

            if isinstance(bin_state, CompactState):
                bin_state = None
            return silhouette_fused(self, Tc_c2b, link_poses, K, sharpness,
                                    state=bin_state)
        Tc_c2l = self.camera_link_poses(Tc_c2b, link_poses)
        if self.mode == "brute":
            return silhouette_bruteforce(self._triangles(Tc_c2l, K), self.H, self.W, sharpness)
        if not self.tile.use_pallas:
            return silhouette_tiled(self._triangles(Tc_c2l, K), self.H, self.W, self.tile,
                                    sharpness)
        tris = self._triangles_soa(Tc_c2l, K)
        if bin_state is not None or self.tile.binner == "count":
            from .binning import silhouette_counted

            return silhouette_counted(tris, self.H, self.W, self.tile, sharpness,
                                      state=bin_state)
        return silhouette_tiled(tris, self.H, self.W, self.tile, sharpness)

    @torch.no_grad()
    def depth(self, Tc_c2b, link_poses, K):
        """-> (depth [..., H, W] metric z, link_id [..., H, W] int32, -1 = bg)."""
        tris = self._triangles(self.camera_link_poses(Tc_c2b, link_poses), K)
        if self.mode == "brute":
            z, tid = depth_bruteforce(tris, self.H, self.W)
        else:
            z, tid = depth_tiled(tris, self.H, self.W, self.tile)
        face_ids = torch.cat([self.face_link_id.to(torch.int32),
                              torch.full((1,), -1, dtype=torch.int32, device=self.device)])
        link_id = face_ids[torch.where(tid >= 0, tid, self.faces.shape[0]).long()]
        return z, link_id

    def link_silhouettes(self, Tc_c2b, link_poses, K, sharpness: float = 1.0):
        """Per-link masks [..., L, H, W], one render per link (K5 on the
        kernel route)."""
        Tc_c2l = self.camera_link_poses(Tc_c2b, link_poses)
        if self.kernel_route:
            tris = self._triangles_soa(Tc_c2l, K)
        else:
            tris = self._triangles(Tc_c2l, K)

        def one(link):
            masked = tris._replace(valid=tris.valid & (self.face_link_id == link))
            if self.mode == "brute":
                return silhouette_bruteforce(masked, self.H, self.W, sharpness)
            return silhouette_tiled(masked, self.H, self.W, self.tile, sharpness)

        return torch.stack([one(l) for l in range(self.n_links)], dim=-3)
