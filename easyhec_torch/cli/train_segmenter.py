"""Segmenter training CLI: synthetic multi-view data -> U-Net -> weights.

Counterpart of easyhec_tpu/cli/train_segmenter.py. Usage:

    python -m easyhec_torch.cli.train_segmenter -c configs/sim_mini.yaml \\
        --out seg.pkl [--data-out DIR] [--n-cams 6] [--frames-per-cam 8] \\
        [--steps 600] [--eval-dir DIR [--eval-overlays DIR]] \\
        [--device cuda|cpu] [model.H=120 ...]

Renders a ring of camera viewpoints with the port's rasterizer (K4f on the
card), splits train/val with a seeded numpy permutation, trains the U-Net
(models/segmentation.py), reports the val IoU, saves the weights as the
flax-layout pickle both packages read, and prints the report as JSON. With
--eval-dir it also scores the segmenter on a reference-format capture dir
(real photos and hand masks). The run goes on CUDA unless ``--device cpu``
is given; ``train(cfg, ...)`` takes an in-memory Config.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..data.synthetic import generate_dataset
from ..geometry import camera, se3
from ..models.segmentation import SegmenterMaskSource, save_params, train_segmenter


def _iou(pred: np.ndarray, ref: np.ndarray) -> float:
    return float((pred & ref).sum() / max((pred | ref).sum(), 1))


def train(cfg, out, data_out=None, n_cams: int = 6, frames_per_cam: int = 8,
          radius: float = 1.5, height: float = 0.8, steps: int = 600,
          val_fraction: float = 0.2, seed: int = 0, eval_dir=None, eval_overlays=None,
          device=None) -> dict:
    """Render the ring dataset on ``device`` (None = CUDA), train, save the
    weights to ``out`` and return the report. The synthetic frames go under
    ``data_out`` (one ``camNN`` capture dir per view) or a temporary dir."""
    from ..trainer import build_runtime

    rt = build_runtime(cfg, device)
    H, W = cfg.model.H, cfg.model.W
    fx = 1.2 * max(H, W)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    # ring of camera poses, one synthetic capture set per viewpoint
    rings = camera.ring_poses(n_cams, radius, height, target=torch.tensor([0.0, 0.0, 0.25]))
    rgbs, masks = [], []
    with tempfile.TemporaryDirectory() as tmp:
        base_dir = Path(data_out) if data_out else Path(tmp)
        for ci in range(n_cams):
            Tc = se3.inverse(rings[ci]).numpy()
            data = generate_dataset(base_dir / f"cam{ci:02d}", rt.chain, rt.renderer,
                                    rt.link_names, Tc, K, n_frames=frames_per_cam,
                                    seed=seed + ci)
            rgbs.append(data["rgb"])
            masks.append((data["masks"] > 0.5).astype(np.float32))
    rgb = np.concatenate(rgbs)
    mask = np.concatenate(masks)

    # deterministic split (the split_mask_training_data role)
    order = np.random.default_rng(seed).permutation(len(rgb))
    n_val = max(1, int(len(rgb) * val_fraction))
    val_idx, train_idx = order[:n_val], order[n_val:]

    params, loss = train_segmenter(rgb[train_idx], mask[train_idx], steps=steps, seed=seed,
                                   device=device)
    save_params(out, params)

    seg = SegmenterMaskSource(params, device=device)
    ious = [_iou(seg.predict(rgb[i]) > 0.5, mask[i] > 0.5) for i in val_idx]
    report = {
        "train_frames": int(len(train_idx)),
        "val_frames": int(len(val_idx)),
        "final_loss": round(loss, 5),
        "val_iou_mean": round(float(np.mean(ious)), 4),
        "val_iou_min": round(float(np.min(ious)), 4),
        "weights": str(out),
    }
    if eval_dir:
        # the sim-to-real check: predict on a capture dir of real photos and
        # score against its hand masks
        from ..data.dataset import load_calib_dataset
        from ..utils.imaging import save_image, vis_mask

        batch = load_calib_dataset(eval_dir, rt.chain, rt.link_names)
        preds = [seg.predict(f) for f in batch.rgb]
        real = [_iou(p > 0.5, m > 0.5) for p, m in zip(preds, batch.masks)]
        report["real_eval"] = {
            "dir": str(eval_dir),
            "per_frame_iou": [round(v, 4) for v in real],
            "mean_iou": round(float(np.mean(real)), 4),
        }
        if eval_overlays:
            ov = Path(eval_overlays)
            ov.mkdir(parents=True, exist_ok=True)
            for i, (f, p) in enumerate(zip(batch.rgb, preds)):
                save_image(ov / f"real_{i:03d}.png", vis_mask(f, p, color=(0, 255, 0)))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train the robot mask segmenter")
    ap.add_argument("-c", "--config-file", required=True)
    ap.add_argument("--out", required=True, help="weights output (.pkl)")
    ap.add_argument("--data-out", default=None, help="also keep the synthetic data here")
    ap.add_argument("--n-cams", type=int, default=6)
    ap.add_argument("--frames-per-cam", type=int, default=8)
    ap.add_argument("--radius", type=float, default=1.5)
    ap.add_argument("--height", type=float, default=0.8)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--val-fraction", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-dir", default=None,
                    help="reference-format capture dir with REAL photos + "
                    "masks: report the sim-to-real IoU after training")
    ap.add_argument("--eval-overlays", default=None,
                    help="with --eval-dir: write prediction overlays here")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    from ..config import load_config

    cfg = load_config(args.config_file, args.opts)
    report = train(cfg, args.out, data_out=args.data_out, n_cams=args.n_cams,
                   frames_per_cam=args.frames_per_cam, radius=args.radius,
                   height=args.height, steps=args.steps, val_fraction=args.val_fraction,
                   seed=args.seed, eval_dir=args.eval_dir,
                   eval_overlays=args.eval_overlays, device=args.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
