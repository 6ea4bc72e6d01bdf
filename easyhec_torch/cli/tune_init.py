"""Initial-pose tuning tool.

Counterpart of easyhec_tpu/cli/tune_init.py. Usage:

    python -m easyhec_torch.cli.tune_init -c configs/sim_mini.yaml \\
        (--eye X Y Z --target X Y Z [--offset-xyz ..] [--offset-rpy ..] | --global-search) \\
        [--frame I] [--out DIR] [--device cuda|cpu] [model.H=120 ...]

From a look-at guess plus optional offsets (the rotation applied in the
camera frame), or from the render-and-score global search (K5f/K5b on the
card), it renders the arm over one dataset frame, writes the overlay PNG
(``tune_overlay.png`` under ``--out``, default ``output_dir/tune_init``),
scores the IoU, and prints it as JSON with the yaml snippet to paste into
the config. The run goes on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def tune_init(cfg, batch=None, frame: int = 0, eye=None, target=None,
              offset_xyz=(0.0, 0.0, 0.0), offset_rpy=(0.0, 0.0, 0.0),
              global_search: bool = False, out=None, device=None):
    """The initial pose for frame ``frame`` of the dataset (``batch``, or
    cfg.dataset.data_dir), on ``device`` (None = CUDA). Returns (Tc_c2b
    [4, 4], {"overlay_iou", and "search_iou" after a global search})."""
    import torch

    from ..data import load_calib_dataset
    from ..geometry import so3
    from ..models.pose_init import global_search_init, lookat_init
    from ..trainer import build_runtime
    from ..utils.imaging import save_image, vis_mask

    rt = build_runtime(cfg, device)
    if batch is None:
        batch = load_calib_dataset(cfg.dataset.data_dir, rt.chain, rt.link_names)
    i = frame
    out_dir = Path(out or (Path(cfg.output_dir) / "tune_init"))
    out_dir.mkdir(parents=True, exist_ok=True)
    if global_search:
        res = global_search_init(rt.renderer, batch.link_poses[i], batch.K, batch.masks[i])
        T = res.Tc_c2b
        extra = {"search_iou": round(res.score, 4)}
    else:
        if eye is None or target is None:
            raise ValueError("eye and target are required without global_search")
        T = lookat_init(eye, target)
        # manual nudging in the camera frame
        dR = so3.exp(torch.as_tensor(np.asarray(offset_rpy, np.float32))).numpy()
        T[:3, :3] = dR @ T[:3, :3]
        T[:3, 3] = T[:3, 3] + np.asarray(offset_xyz, np.float32)
        extra = {}
    dev = rt.renderer.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    with torch.no_grad():
        sil = rt.renderer.silhouette(t(T), t(batch.link_poses[i]), t(batch.K)).cpu().numpy()
    ref = batch.masks[i] > 0.5
    pred = sil > 0.5
    iou = float((pred & ref).sum() / max((pred | ref).sum(), 1))
    overlay = vis_mask(batch.rgb[i], sil, color=(0, 255, 0), alpha=0.5)
    overlay = vis_mask(overlay, batch.masks[i], color=(255, 0, 0), alpha=0.25)
    save_image(out_dir / "tune_overlay.png", overlay)
    return T, {"overlay_iou": round(iou, 4), **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tune/solve the initial Tc_c2b")
    ap.add_argument("-c", "--config-file", required=True)
    ap.add_argument("--eye", type=float, nargs=3, default=None)
    ap.add_argument("--target", type=float, nargs=3, default=None)
    ap.add_argument("--offset-xyz", type=float, nargs=3, default=(0, 0, 0))
    ap.add_argument("--offset-rpy", type=float, nargs=3, default=(0, 0, 0),
                    help="extra rotation (rad), applied in camera frame")
    ap.add_argument("--global-search", action="store_true")
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    from ..config import load_config

    if not args.global_search and (args.eye is None or args.target is None):
        raise SystemExit("--eye/--target required (or use --global-search)")
    cfg = load_config(args.config_file, args.opts)
    T, info = tune_init(cfg, frame=args.frame, eye=args.eye, target=args.target,
                        offset_xyz=args.offset_xyz, offset_rpy=args.offset_rpy,
                        global_search=args.global_search, out=args.out, device=args.device)
    print(json.dumps(info))
    print("# paste into the config:")
    print("model:")
    print("  init_Tc_c2b:")
    for row in T.tolist():
        print(f"  - {row}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
