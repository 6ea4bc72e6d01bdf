"""Main CLI: offline or iterative (online) calibration.

Counterpart of easyhec_tpu/cli/run.py. Usage:

    python -m easyhec_torch.cli.run -c configs/sim_mini.yaml \\
        [solver.max_lr=0.01 ...] [--iterative] [--device cuda|cpu]

The run goes on CUDA unless ``--device cpu`` is given. ``--iterative`` runs
the online loop (trainer.run_iterative). With no hardware adapters on the
command line, it runs the simulated closed loop against the ground truth of
a dataset written by ``easyhec_torch.cli.simulate`` (``K.txt`` and
``Tc_c2b.txt`` in ``dataset.data_dir``), starting from that ground truth
perturbed in se(3) unless the config sets an initial pose.

Multi-process runs rendezvous from the environment, as the JAX CLI's do
(parallel.maybe_init_from_env): ``EASYHEC_COORDINATOR=host:port
EASYHEC_NUM_PROCESSES=N EASYHEC_PROCESS_ID=i`` starts a process group
(NCCL on CUDA, gloo with ``--device cpu``); each process then runs the run
it was given.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def perturbed_start(Tc_c2b_gt, seed: int) -> list:
    """The simulated loop's start pose: the GT perturbed by N(0, 0.02) in
    se(3) with numpy seed ``seed``, as easyhec_tpu's CLI does (a 4×4 list)."""
    import torch

    from ..geometry import se3

    xi = se3.log(torch.tensor(np.asarray(Tc_c2b_gt), dtype=torch.float32)).numpy()
    xi = (xi + np.random.default_rng(seed).normal(0, 0.02, 6)).astype(np.float32)
    return se3.exp(torch.from_numpy(xi)).numpy().tolist()


def _simulated_rig(cfg) -> dict:
    """K and the GT pose from cfg.dataset.data_dir when it holds a simulated
    dataset (else {}); captures then go under the run dir, and an "auto"
    init without a pose starts from perturbed_start(GT, cfg.solver.seed)."""
    ddir = pathlib.Path(cfg.dataset.data_dir or "")
    if not ((ddir / "K.txt").exists() and (ddir / "Tc_c2b.txt").exists()):
        return {}
    kw = {"K": np.loadtxt(ddir / "K.txt"), "Tc_c2b_gt": np.loadtxt(ddir / "Tc_c2b.txt")}
    cfg.dataset.data_dir = ""  # never clobber the GT dataset
    print(f"simulated closed loop against GT from {ddir}")
    if cfg.model.init_Tc_c2b is None and cfg.model.init_method == "auto":
        cfg.model.init_Tc_c2b = perturbed_start(kw["Tc_c2b_gt"], cfg.solver.seed)
        print("sim init: GT perturbed by sigma=0.02")
    return kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="easyhec_torch calibration")
    ap.add_argument("-c", "--config-file", required=True)
    ap.add_argument("opts", nargs="*", help="dotted config overrides key=value")
    ap.add_argument("--iterative", action="store_true", help="run the online explore loop")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..config import load_config

    cfg = load_config(args.config_file, args.opts)

    # Multi-process rendezvous from env (the reference's WORLD_SIZE/
    # LOCAL_RANK + NCCL bootstrap, tools/run_easyhec.py:41-50).
    from ..parallel import maybe_init_from_env

    maybe_init_from_env(backend="gloo" if args.device == "cpu" else None)
    if args.iterative:
        from ..trainer import run_iterative

        result = run_iterative(cfg, device=args.device, **_simulated_rig(cfg))
    else:
        from ..trainer import run_offline_calibration

        result = run_offline_calibration(cfg, device=args.device)
    print("solved Tc_c2b:")
    print(result.Tc_c2b)
    if result.metrics:
        print("metrics:", json.dumps(result.metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
