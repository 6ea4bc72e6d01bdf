"""Checkpoint save/load.

Replaces torch .pth checkpoints (reference easyhec/trainer/base.py:374-455,
including the 'latest' glob resume convention) with npz + JSON metadata.
The reference abused checkpoints as IPC (SpaceExplorer reads history_ops out
of the latest .pth, space_explorer.py:30-35) — here history is a first-class
array in the result/checkpoint.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]


def save_checkpoint(
    path: str | Path, arrays: dict[str, np.ndarray], meta: dict | None = None
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path.with_suffix(".npz"), **{k: np.asarray(v) for k, v in arrays.items()})
    if meta is not None:
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2, default=str))
    return path.with_suffix(".npz")


def load_checkpoint(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    data = dict(np.load(path))
    meta_path = path.with_suffix(".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return data, meta


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """Resume convention: newest *.npz under the checkpoint dir (the
    reference globs 'latest' the same way, base.py:420-440)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    cands = sorted(ckpt_dir.glob("*.npz"))
    return cands[-1] if cands else None
