"""Calibration dataset: on-disk format compatible with the reference.

Copy of easyhec_tpu/data/dataset.py (host numpy; the FK runs through the
port's ``KinematicChain.fk_np``). Directory layout:

    data_dir/
      color/000000.png ...      RGB captures
      mask/000000.png ...       segmentation masks (any nonzero = robot)
      qpos/000000.txt ...       joint positions, one value per line/space-sep
      K.txt                     3x3 intrinsics
      Tc_c2b.txt                optional 4x4 GT camera-from-base (identity =
                                "no GT", reference convention)

The whole capture set loads at once: calibration datasets are 10-20 frames
and the problem is one full-batch optimization. Frames are written and
read with the standard-library PNG codec (utils.imaging.write_png and
read_png); OpenCV (``cv2``) is imported only to read another format.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..robot import KinematicChain

__all__ = ["CalibBatch", "load_calib_dataset", "save_calib_frame", "save_calib_dataset"]


@dataclass
class CalibBatch:
    """Full-batch calibration data (host numpy; move to device at use site).

    rgb: [B, H, W, 3] uint8 (may be zeros if only masks exist)
    masks: [B, H, W] float32 in {0, 1}
    qpos: [B, n_dof] float32
    link_poses: [B, L, 4, 4] float32 — FK poses of the selected links
    K: [3, 3] float32
    Tc_c2b_gt: [4, 4] float32 (identity = no ground truth)
    """

    rgb: np.ndarray
    masks: np.ndarray
    qpos: np.ndarray
    link_poses: np.ndarray
    K: np.ndarray
    Tc_c2b_gt: np.ndarray

    @property
    def n_frames(self) -> int:
        return int(self.masks.shape[0])

    @property
    def has_gt(self) -> bool:
        return not np.allclose(self.Tc_c2b_gt, np.eye(4))


def _imread(path: Path) -> np.ndarray:
    if path.suffix.lower() == ".png":
        from ..utils.imaging import read_png

        return read_png(path)
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2RGB)
    return img


def load_calib_dataset(
    data_dir: str | Path,
    chain: KinematicChain,
    link_names: list[str],
    qpos_pad: int | None = None,
) -> CalibBatch:
    """Load a capture directory and FK the selected links per frame.

    qpos files may have fewer values than chain.n_dof (e.g. arm-only capture
    for an arm+gripper URDF); missing joints are zero-padded, matching the
    reference's behavior of FK-ing with captured arm qpos only.
    """
    data_dir = Path(data_dir).expanduser()
    mask_files = sorted((data_dir / "mask").glob("*.png"))
    if not mask_files:
        raise FileNotFoundError(f"no masks under {data_dir}/mask")
    qpos_files = sorted((data_dir / "qpos").glob("*.txt"))
    color_files = sorted((data_dir / "color").glob("*.png"))
    if len(qpos_files) != len(mask_files):
        raise ValueError(
            f"{len(mask_files)} masks but {len(qpos_files)} qpos files in {data_dir}"
        )

    masks = np.stack([(_imread(p) > 0) for p in mask_files]).astype(np.float32)
    if masks.ndim == 4:  # RGB-saved masks
        masks = masks[..., 0]

    qpos_list = [np.loadtxt(p).reshape(-1) for p in qpos_files]
    n = chain.n_dof if qpos_pad is None else qpos_pad
    qpos = np.zeros((len(qpos_list), n), dtype=np.float32)
    for i, q in enumerate(qpos_list):
        m = min(len(q), n)
        qpos[i, :m] = q[:m]

    link_idx = [chain.link_index(nm) for nm in link_names]
    poses = np.stack([chain.fk_np(q) for q in qpos])  # [B, n_links, 4, 4]
    link_poses = poses[:, link_idx]

    K = np.loadtxt(data_dir / "K.txt").astype(np.float32).reshape(3, 3)
    gt_path = data_dir / "Tc_c2b.txt"
    Tc_gt = (
        np.loadtxt(gt_path).astype(np.float32).reshape(4, 4)
        if gt_path.exists()
        else np.eye(4, dtype=np.float32)
    )

    if color_files and len(color_files) == len(mask_files):
        rgb = np.stack([_imread(p) for p in color_files]).astype(np.uint8)
    else:
        rgb = np.zeros(masks.shape + (3,), dtype=np.uint8)

    return CalibBatch(
        rgb=rgb,
        masks=masks,
        qpos=qpos,
        link_poses=link_poses.astype(np.float32),
        K=K,
        Tc_c2b_gt=Tc_gt,
    )


def save_calib_frame(
    data_dir: str | Path,
    index: int,
    rgb: np.ndarray | None,
    mask: np.ndarray,
    qpos: np.ndarray,
) -> None:
    """Write one captured frame in the reference-compatible layout (RGB and
    8-bit mask PNGs through utils.imaging.write_png, which needs no imaging
    package)."""
    from ..utils.imaging import write_png

    data_dir = Path(data_dir)
    for sub in ("color", "mask", "qpos"):
        (data_dir / sub).mkdir(parents=True, exist_ok=True)
    name = f"{index:06d}"
    if rgb is not None:
        write_png(data_dir / "color" / f"{name}.png", np.asarray(rgb, np.uint8))
    write_png(data_dir / "mask" / f"{name}.png",
              (np.asarray(mask) > 0.5).astype(np.uint8) * 255)
    np.savetxt(data_dir / "qpos" / f"{name}.txt", np.asarray(qpos).reshape(-1))


def save_calib_dataset(
    data_dir: str | Path,
    masks: np.ndarray,
    qpos: np.ndarray,
    K: np.ndarray,
    Tc_c2b_gt: np.ndarray | None = None,
    rgb: np.ndarray | None = None,
) -> None:
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(masks)):
        save_calib_frame(
            data_dir, i, None if rgb is None else rgb[i], masks[i], qpos[i]
        )
    np.savetxt(data_dir / "K.txt", np.asarray(K))
    if Tc_c2b_gt is not None:
        np.savetxt(data_dir / "Tc_c2b.txt", np.asarray(Tc_c2b_gt))
