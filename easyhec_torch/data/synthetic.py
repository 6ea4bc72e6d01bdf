"""Synthetic calibration-data generator (the closed-loop test rig).

Torch counterpart of easyhec_tpu/data/synthetic.py: renders a ground-truth
dataset with the port's own rasterizer, in the reference-compatible
directory layout. Masks are the renderer's silhouettes at the GT pose
(K4 or K5, by the tile config), depth and per-pixel triangle ids come from
the tiled depth pass, and the RGB image is flat-shaded Lambertian from the
hit face's camera-frame normal.

Joint configurations are drawn with a ``torch.Generator`` seeded from
``seed``; the JAX package draws them with jax.random, so the two produce
different configurations from one seed. Pass ``qposes`` to render the same
ones. ``generate_pose_dataset`` (the ``--ring`` CLI) writes the pose
dataset: one fixed qpos seen from a ring of cameras; its PNGs go through
utils.imaging.write_png (no PIL).
"""
from __future__ import annotations

import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from ..geometry import camera, se3
from ..render.projection import transform_verts
from ..render.renderer import RobotRenderer
from ..render.tiled import depth_tiled
from ..robot import KinematicChain
from ..utils.imaging import write_png
from ..utils.scene3d import _write_ply
from .dataset import save_calib_dataset

__all__ = [
    "sample_qposes",
    "make_render_fn",
    "generate_dataset",
    "generate_pose_dataset",
    "split_dataset",
    "default_camera",
]

_LIGHT = (0.3, -0.5, -0.8)


def sample_qposes(generator: torch.Generator, chain: KinematicChain, n: int,
                  limit_fraction: float = 0.5) -> torch.Tensor:
    """Uniform random joint configurations [n, n_dof] within the joint limits
    scaled by limit_fraction (on the generator's device)."""
    lim = torch.as_tensor(chain.joint_limits, dtype=torch.float32)
    lo, hi = lim[:, 0] * limit_fraction, lim[:, 1] * limit_fraction
    u = torch.rand((n, chain.n_dof), generator=generator, device=generator.device)
    return lo.to(u.device) + (hi - lo).to(u.device) * u


def _face_normals(renderer: RobotRenderer, Tc_c2l: torch.Tensor) -> torch.Tensor:
    """Camera-frame unit normals [..., F, 3] of the packed faces under
    per-link poses [..., L, 4, 4]."""
    verts = transform_verts(renderer.vertices, renderer.vert_link_id, Tc_c2l)
    tri = verts[..., renderer.faces.long(), :]  # [..., F, 3, 3]
    n = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :],
                           dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def make_render_fn(chain: KinematicChain, renderer: RobotRenderer, link_names: list[str],
                   K: np.ndarray):
    """(Tc_c2b [4, 4], qposes [B, n_dof]) -> (masks, depth, link_id, gray),
    each [B, H, W], on the renderer's device."""
    dev = renderer.device
    link_idx = [chain.link_index(n) for n in link_names]
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
    light = torch.tensor(_LIGHT, device=dev)
    light = light / torch.linalg.norm(light)

    @torch.no_grad()
    def render(Tc, qs):
        lp = chain.fk(qs)[:, link_idx]  # [B, L, 4, 4]
        masks = renderer.silhouette(Tc, lp, Kt)
        Tc_c2l = renderer.camera_link_poses(Tc, lp)
        depth, tid = depth_tiled(renderer._triangles(Tc_c2l, Kt), renderer.H, renderer.W,
                                 renderer.tile)
        F = renderer.faces.shape[0]
        face_ids = torch.cat([renderer.face_link_id.to(torch.int32),
                              torch.full((1,), -1, dtype=torch.int32, device=dev)])
        pick = torch.where(tid >= 0, tid, F).long()
        link_id = face_ids[pick]
        # Flat-shaded gray: Lambertian from the hit face's camera normal.
        lam = torch.abs(_face_normals(renderer, Tc_c2l) @ light)  # [B, F]
        lam = torch.cat([lam, lam.new_zeros(lam.shape[:-1] + (1,))], dim=-1)
        shade = lam.gather(-1, pick.reshape(pick.shape[0], -1)).reshape(pick.shape)
        gray = torch.where(tid >= 0, 0.25 + 0.75 * shade, torch.full_like(shade, 0.08))
        return masks, depth, link_id, gray

    return render


def generate_dataset(
    out_dir: str | Path,
    chain: KinematicChain,
    renderer: RobotRenderer,
    link_names: list[str],
    Tc_c2b: np.ndarray,
    K: np.ndarray,
    n_frames: int = 10,
    seed: int = 0,
    limit_fraction: float = 0.5,
    qposes: np.ndarray | None = None,
    write_depth: bool = False,
    render_fn=None,
) -> dict[str, np.ndarray]:
    """Render a GT dataset in the reference-compatible directory layout.

    Returns {"masks", "qpos", "rgb", "depth", "link_id"} as host numpy too.
    Pass render_fn (from make_render_fn) to reuse it across calls."""
    dev = renderer.device
    if qposes is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        qposes = sample_qposes(gen, chain, n_frames, limit_fraction)
    qs = torch.as_tensor(np.asarray(qposes) if not torch.is_tensor(qposes) else qposes,
                         dtype=torch.float32, device=dev)
    Tc = torch.as_tensor(np.asarray(Tc_c2b), dtype=torch.float32, device=dev)
    if render_fn is None:
        render_fn = make_render_fn(chain, renderer, link_names, K)
    masks, depth, link_id, gray = (x.cpu().numpy() for x in render_fn(Tc, qs))
    rgb = (np.repeat(gray[..., None], 3, axis=-1) * 255).astype(np.uint8)
    qpos_np = qs.cpu().numpy()
    save_calib_dataset(out_dir, masks=(masks > 0.5).astype(np.float32), qpos=qpos_np,
                       K=np.asarray(K), Tc_c2b_gt=np.asarray(Tc_c2b), rgb=rgb)
    if write_depth:
        ddir = Path(out_dir) / "depth"
        ddir.mkdir(parents=True, exist_ok=True)
        for i, d in enumerate(depth):
            np.save(ddir / f"{i:06d}.npy", d)
    return {"masks": masks, "qpos": qpos_np, "rgb": rgb, "depth": depth, "link_id": link_id}


def generate_pose_dataset(
    out_dir: str | Path,
    chain: KinematicChain,
    renderer: RobotRenderer,
    link_names: list[str],
    K: np.ndarray,
    n_views: int = 36,
    radius: float = 1.5,
    height: float = 0.8,
    qpos: np.ndarray | None = None,
    target=(0.0, 0.0, 0.25),
    seed: int = 0,
    jitter: float = 0.0,
) -> dict[str, np.ndarray]:
    """Pose-training dataset: one fixed qpos (zeros by default) seen from
    ``n_views`` cameras on a ring, in the layout

        color/%06d.png  mask/%06d.png  pose/%06d.txt  (Tc_c2b per view)
        K.txt  qpos.txt  model.ply  diameter.txt

    model.ply is the robot posed at ``qpos`` in the base frame; diameter the
    norm of its vertices' bbox extent. ``jitter`` adds numpy normal(0,
    jitter) noise (seeded) to each view's translation. Returns {"poses",
    "masks", "diameter"}."""
    out = Path(out_dir)
    dev = renderer.device
    qpos = np.zeros(chain.n_dof, np.float32) if qpos is None else np.asarray(qpos)
    link_idx = [chain.link_index(n) for n in link_names]
    lp = chain.fk(torch.as_tensor(qpos, dtype=torch.float32))[link_idx]  # [L, 4, 4]
    rng = np.random.default_rng(seed)
    rings = camera.ring_poses(n_views, radius, height,
                              target=torch.tensor(target, dtype=torch.float32))
    poses = se3.inverse(rings)  # Tc_c2b per view
    if jitter > 0:
        noise = rng.normal(0, jitter, (n_views, 3)).astype(np.float32)
        poses[:, :3, 3] += torch.from_numpy(noise)
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
    lp_d = lp.to(dev)
    with torch.no_grad():
        masks = renderer.silhouette(poses.to(dev), lp_d.expand((n_views,) + lp_d.shape),
                                    Kt).cpu().numpy()
    for sub in ("color", "mask", "pose"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n_views):
        # the flat mask stands in for the color image (a shape cue only)
        m8 = (masks[i] > 0.5).astype(np.uint8) * 255
        write_png(out / "color" / f"{i:06d}.png", m8)
        write_png(out / "mask" / f"{i:06d}.png", m8)
        np.savetxt(out / "pose" / f"{i:06d}.txt", poses[i].numpy())
    np.savetxt(out / "K.txt", np.asarray(K))
    np.savetxt(out / "qpos.txt", qpos)
    verts = transform_verts(renderer.vertices, renderer.vert_link_id, lp_d).cpu().numpy()
    _write_ply(out / "model.ply", verts, renderer.faces.cpu().numpy())
    diameter = float(np.linalg.norm(verts.max(axis=0) - verts.min(axis=0)))
    (out / "diameter.txt").write_text(f"{diameter}\n")
    return {"poses": poses.numpy(), "masks": masks, "diameter": diameter}


def split_dataset(
    src_dir: str | Path,
    out_dir: str | Path | None = None,
    train_fraction: float = 0.8,
    seed: int = 0,
) -> tuple[list[int], list[int]]:
    """Split a generated dataset into train/ and val/ subsets by file copy
    (numpy permutation from ``seed``, as the JAX package). Per-frame files
    of the known subdirs are renumbered; the known frame-independent
    top-level files are copied into both; other top-level files are skipped
    with a warning. Returns (train_ids, val_ids)."""
    src = Path(src_dir)
    out = Path(out_dir) if out_dir is not None else src
    subdirs = [d for d in ("color", "mask", "qpos", "pose", "depth") if (src / d).is_dir()]
    if not subdirs:
        raise FileNotFoundError(f"no per-frame subdirs under {src}")
    stems = sorted(p.stem for p in (src / subdirs[0]).iterdir() if p.is_file())
    perm = np.random.default_rng(seed).permutation(len(stems))
    n_train = int(round(len(stems) * train_fraction))
    splits = {"train": sorted(perm[:n_train].tolist()), "val": sorted(perm[n_train:].tolist())}
    shared_names = {"K.txt", "Tc_c2b.txt", "model.ply", "diameter.txt", "meta.json",
                    "camera.json"}
    shared = [p for p in src.iterdir() if p.is_file() and p.name in shared_names]
    skipped = [p.name for p in src.iterdir() if p.is_file() and p.name not in shared_names]
    if skipped:
        warnings.warn(f"split_dataset: not copying unrecognized top-level files {skipped} "
                      "(add frame-independent ones to the whitelist)", stacklevel=2)
    for name, ids in splits.items():
        dst = out / name
        for sub in subdirs:
            (dst / sub).mkdir(parents=True, exist_ok=True)
            files = {p.stem: p for p in (src / sub).iterdir() if p.is_file()}
            for new_i, old_i in enumerate(ids):
                p = files[stems[old_i]]
                shutil.copy2(p, dst / sub / f"{new_i:06d}{p.suffix}")
        for p in shared:
            shutil.copy2(p, dst / p.name)
    return splits["train"], splits["val"]


def default_camera(distance: float = 1.6, azimuth_deg: float = 40.0, height: float = 0.9,
                   target=(0.0, 0.0, 0.25)) -> np.ndarray:
    """A tripod camera pose looking at the robot workspace: Tc_c2b [4, 4]."""
    az = np.deg2rad(azimuth_deg)
    eye = torch.tensor([target[0] + distance * np.cos(az),
                        target[1] + distance * np.sin(az), height], dtype=torch.float32)
    T = camera.look_at(eye, torch.tensor(target, dtype=torch.float32),
                       torch.tensor([0.0, 0.0, 1.0]))
    return se3.inverse(T).numpy()
