"""High-level robot renderer: static mesh arrays and the bin-state entry.

Torch counterpart of easyhec_tpu/render/renderer.py::RobotRenderer. All
links of all frames render in one batched call. The port carries the fused
route (``tile.fused``): the static arrays, ``camera_link_poses``,
``link_aabb_corners``, ``bin_state`` (dense or compact) and ``silhouette``
(the dense silhouette kernels, K4). ``depth``, ``link_silhouettes`` and the
unfused silhouette need the tiled rasterizer (K5) and raise until it is
ported.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..robot.mesh import TriMesh, pack_meshes
from .tiled import TileConfig

__all__ = ["RobotRenderer"]


class RobotRenderer:
    """Renders a set of per-link meshes under per-frame link poses.

    Static data is baked at construction onto ``device`` (None = CUDA; the
    constructor raises when CUDA is absent unless ``device="cpu"``).
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
        if mode != "tiled":
            raise NotImplementedError(
                f"mode={mode!r}: only the tiled fused route is ported (ROADMAP.md)"
            )
        self.device = resolve_device(device)
        packed = pack_meshes(link_meshes)
        self.meshes = list(link_meshes)
        self.n_links = packed.n_meshes
        self.H, self.W = int(H), int(W)
        self.tile = tile or TileConfig()
        self.mode = mode
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

    def camera_link_poses(self, Tc_c2b: torch.Tensor, link_poses: torch.Tensor):
        """Camera-from-link transforms: Tc_c2b [..., 4, 4] camera-from-base,
        link_poses [..., L, 4, 4] base-from-link -> [..., L, 4, 4]."""
        return torch.einsum("...ij,...ljk->...lik", Tc_c2b, link_poses)

    def _require_fused(self, what: str):
        if not self.tile.fused:
            raise NotImplementedError(
                f"RobotRenderer.{what} with tile.fused=False needs the tiled "
                "rasterizer (K5), not ported to easyhec_torch yet (ROADMAP.md)"
            )

    def bin_state(self, Tc_c2b, link_poses, K, sharpness: float = 1.0):
        """Rebin state for the current pose (leaves carry the flattened frame
        batch); reuse it while the pose stays within tile.margin px of where
        it was built: a CompactState when tile.compact_chunks > 0, else a
        FusedState. sharpness must match the loss kernel's when
        tile.bwd_chunks > 0 (it sizes the boundary-prefix band dilation)."""
        self._require_fused("bin_state")
        from .fused import build_compact_state, build_fused_state

        if self.tile.compact_chunks > 0:
            return build_compact_state(self, Tc_c2b, link_poses, K, sharpness=sharpness)
        return build_fused_state(self, Tc_c2b, link_poses, K)

    def silhouette(self, Tc_c2b, link_poses, K, sharpness: float = 1.0,
                   bin_state=None):
        """Soft silhouette of the whole arm (union of links) in [0, 1]:
        Tc_c2b [..., 4, 4], link_poses [..., L, 4, 4], K [3, 3] -> [..., H, W].
        Differentiable in Tc_c2b. bin_state: an optional FusedState (from
        self.bin_state); a CompactState drives the loss only, so it is
        dropped and the bins are rebuilt densely."""
        self._require_fused("silhouette")
        from .fused import CompactState, silhouette_fused

        if isinstance(bin_state, CompactState):
            bin_state = None
        return silhouette_fused(self, Tc_c2b, link_poses, K, sharpness, state=bin_state)

    def _later(self, name):
        raise NotImplementedError(
            f"RobotRenderer.{name} is not ported to easyhec_torch yet "
            "(ROADMAP.md queue item 7; it needs the tiled rasterizer, K5)"
        )

    def depth(self, *args, **kwargs):
        self._later("depth")

    def link_silhouettes(self, *args, **kwargs):
        self._later("link_silhouettes")
