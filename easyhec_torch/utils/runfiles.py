"""Run-directory management: archiving, source snapshots, determinism.

Torch-package copy of easyhec_tpu/utils/runfiles.py (the reference's
os_utils: archive_runs, make_source_code_snapshot, deterministic), standard
library only, except that ``deterministic_seed`` also returns an explicit
``torch.Generator``: the port draws its random numbers from generators it
is handed, not from the global seed alone.
"""
from __future__ import annotations

import random
import shutil
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["archive_runs", "make_source_snapshot", "deterministic_seed"]


def archive_runs(output_dir: str | Path, keep: int = 20) -> Path | None:
    """Move the previous contents of output_dir into
    output_dir/archive/<timestamp>/ so each run starts clean but history is
    kept (at most ``keep`` archives). Returns the archive path (or None)."""
    out = Path(output_dir)
    if not out.exists():
        return None
    entries = [p for p in out.iterdir() if p.name != "archive"]
    if not entries:
        return None
    stamp = time.strftime("%Y%m%d_%H%M%S")
    dst = out / "archive" / stamp
    dst.mkdir(parents=True, exist_ok=True)
    for p in entries:
        shutil.move(str(p), str(dst / p.name))
    archives = sorted((out / "archive").iterdir())
    for old in archives[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return dst


def make_source_snapshot(output_dir: str | Path, package_root: str | Path | None = None) -> Path:
    """Copy the package source (this package by default) into the run dir
    for reproducibility."""
    root = Path(package_root) if package_root else Path(__file__).resolve().parents[1]
    dst = Path(output_dir) / "source_snapshot" / root.name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root, dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc", ".git",
                                                            "build"))
    return dst


def deterministic_seed(seed: int = 0, device=None) -> torch.Generator:
    """Seed every host-side RNG in play (random, numpy, torch's global
    generators) and return a ``torch.Generator`` on ``device`` (CPU by
    default) seeded with ``seed``, to pass to the draws explicitly."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)
