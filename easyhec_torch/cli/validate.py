"""Validation tool: overlay the solved pose's renders on the captured images.

Counterpart of easyhec_tpu/cli/validate.py. Usage:

    python -m easyhec_torch.cli.validate -c configs/sim_mini.yaml \\
        [--ckpt PATH.npz] [--out DIR] [--device cuda|cpu] [model.H=120 ...]

Loads the checkpoint's ``dof`` (default: the newest ``*.npz`` under
``output_dir/checkpoints``), renders every frame at that pose
(``render_outputs``: K4f on the dense fused route), writes the hover-mask
overlays and ``report.json`` (per-frame mask IoU, mean IoU, Tc_c2b) to
``--out`` (default ``output_dir/validate``), and prints the report. The run
goes on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def validate(cfg, ckpt=None, out=None, batch=None, device=None) -> dict:
    """Render, overlay and score ``ckpt``'s pose over the dataset (``batch``,
    or cfg.dataset.data_dir) on ``device`` (None = CUDA); write the overlays
    and report.json under ``out``. Returns the report."""
    import torch

    from ..data import load_calib_dataset
    from ..evaluators import build_evaluators
    from ..geometry import se3
    from ..models.calib import render_outputs
    from ..trainer import build_runtime
    from ..utils.checkpoint import latest_checkpoint, load_checkpoint
    from ..visualizers import build_visualizer

    rt = build_runtime(cfg, device)
    if batch is None:
        batch = load_calib_dataset(cfg.dataset.data_dir, rt.chain, rt.link_names)
    ckpt = ckpt or latest_checkpoint(Path(cfg.output_dir) / "checkpoints")
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {cfg.output_dir}/checkpoints")
    dof = load_checkpoint(ckpt)[0]["dof"]
    rendered = render_outputs(dof, rt.renderer, batch.link_poses, batch.K,
                              batch.masks)["rendered_masks"]
    out_dir = Path(out or (Path(cfg.output_dir) / "validate"))
    build_visualizer("hover_mask", out_dir)(batch.rgb, rendered)
    iou_eval = build_evaluators(["mask_iou"])[0]
    stats = [{"frame": i, "iou": round(iou_eval({"rendered_masks": rendered[i:i + 1],
                                                 "ref_masks": batch.masks[i:i + 1]})["mask_iou"],
                                        4)}
             for i in range(batch.n_frames)]
    Tc = se3.exp(torch.as_tensor(np.asarray(dof), dtype=torch.float32)).numpy()
    report = {
        "checkpoint": str(ckpt),
        "Tc_c2b": Tc.tolist(),
        "mean_iou": round(float(np.mean([s["iou"] for s in stats])), 4),
        "frames": stats,
    }
    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="overlay solved-pose renders")
    ap.add_argument("-c", "--config-file", required=True)
    ap.add_argument("--ckpt", default=None, help="checkpoint (.npz); default: latest in output_dir")
    ap.add_argument("--out", default=None, help="overlay output dir")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    from ..config import load_config

    cfg = load_config(args.config_file, args.opts)
    try:
        report = validate(cfg, ckpt=args.ckpt, out=args.out, device=args.device)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
