"""Synthetic-data CLI.

Counterpart of easyhec_tpu/cli/simulate.py: renders a GT dataset with the
port's rasterizer (masks, flat-shaded RGB, optional depth) in the
reference-compatible layout. Usage:

    python -m easyhec_torch.cli.simulate -c configs/sim_mini.yaml --out DIR \\
        [--n-frames N] [--seed S] [--depth] [--split FRAC] [--device cuda|cpu] \\
        [model.H=120 ...]

The run goes on CUDA unless ``--device cpu`` is given. The joint
configurations come from a torch.Generator seeded with ``--seed``, so they
differ from the JAX package's for the same seed. ``--ring N`` writes the
pose dataset instead (data.synthetic.generate_pose_dataset): the zero qpos
from N cameras on a ring of radius ``--distance`` at ``--height``.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="generate synthetic calibration data")
    ap.add_argument("-c", "--config-file", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-frames", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distance", type=float, default=1.6)
    ap.add_argument("--azimuth", type=float, default=40.0)
    ap.add_argument("--height", type=float, default=0.9)
    ap.add_argument("--limit-fraction", type=float, default=0.5)
    ap.add_argument("--depth", action="store_true", help="also write depth maps")
    ap.add_argument("--ring", type=int, default=0, metavar="N",
                    help="pose-dataset mode: N camera views on a ring, one fixed qpos")
    ap.add_argument("--split", type=float, default=0.0, metavar="FRAC",
                    help="after generation, split into train/ and val/ with FRAC of "
                    "frames in train")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    import numpy as np

    from ..config import load_config
    from ..data.synthetic import (default_camera, generate_dataset, generate_pose_dataset,
                                  split_dataset)
    from ..trainer import build_runtime

    cfg = load_config(args.config_file, args.opts)
    rt = build_runtime(cfg, device=args.device)
    fx = 1.2 * max(cfg.model.H, cfg.model.W)
    K = np.array([[fx, 0, cfg.model.W / 2], [0, fx, cfg.model.H / 2], [0, 0, 1]], np.float32)
    if args.ring:
        out = generate_pose_dataset(args.out, rt.chain, rt.renderer, rt.link_names, K,
                                    n_views=args.ring, radius=args.distance,
                                    height=args.height, seed=args.seed)
        print(f"wrote {args.ring} ring views to {args.out} "
              f"(model diameter {out['diameter']:.3f} m)")
        return 0
    Tc = default_camera(args.distance, args.azimuth, args.height)
    data = generate_dataset(
        args.out, rt.chain, rt.renderer, rt.link_names, Tc, K, n_frames=args.n_frames,
        seed=args.seed, limit_fraction=args.limit_fraction, write_depth=args.depth,
    )
    cov = (data["masks"] > 0.5).mean()
    print(f"wrote {args.n_frames} frames to {args.out} "
          f"({cfg.model.H}x{cfg.model.W}, mean coverage {cov:.3f})")
    if args.split > 0:
        tr, va = split_dataset(args.out, train_fraction=args.split, seed=args.seed)
        print(f"split: {len(tr)} train / {len(va)} val")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
