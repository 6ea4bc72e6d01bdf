"""Main CLI: offline calibration.

Counterpart of easyhec_tpu/cli/run.py. Usage:

    python -m easyhec_torch.cli.run -c configs/sim_mini.yaml \\
        [solver.max_lr=0.01 ...] [--device cuda|cpu]

The run goes on CUDA unless ``--device cpu`` is given. Not ported yet
(ROADMAP.md): the online explore loop (``--iterative``, queue item 11) and
the multi-process rendezvous (``WORLD_SIZE`` > 1, queue item 14); both
raise.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="easyhec_torch calibration")
    ap.add_argument("-c", "--config-file", required=True)
    ap.add_argument("opts", nargs="*", help="dotted config overrides key=value")
    ap.add_argument("--iterative", action="store_true",
                    help="the online explore loop (not ported yet)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    if args.iterative:
        raise NotImplementedError(
            "--iterative (the online explore loop) is not ported to easyhec_torch "
            "yet (ROADMAP.md queue item 11)"
        )
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "multi-process runs (WORLD_SIZE > 1) are not ported to easyhec_torch "
            "yet (ROADMAP.md queue item 14)"
        )

    from ..config import load_config
    from ..trainer import run_offline_calibration

    cfg = load_config(args.config_file, args.opts)
    result = run_offline_calibration(cfg, device=args.device)
    print("solved Tc_c2b:")
    print(result.Tc_c2b)
    if result.metrics:
        print("metrics:", json.dumps(result.metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
