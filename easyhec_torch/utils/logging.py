"""Logging + metrics sinks.

Counterpart of easyhec_tpu/utils/logging.py: stdlib logging to stdout and
``log.txt``, and a JSONL metrics stream with PNG image panels. The image
panels need matplotlib, which is imported only when a panel is written:
without it the PNG is skipped and one warning is logged. Errors other than
a missing matplotlib are raised, not swallowed.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["setup_logger", "MetricsWriter"]

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
LOGGER = "easyhec_torch"


def setup_logger(output_dir: str | Path | None = None, name: str = LOGGER) -> logging.Logger:
    """The package logger, writing to stdout and, with output_dir, to
    output_dir/log.txt. A later call with another output_dir moves the file
    handler there (one process may run several calibrations)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(sh)
    if output_dir is not None:
        path = Path(output_dir) / "log.txt"
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            if Path(h.baseFilename) == path.resolve():
                return logger
            logger.removeHandler(h)
            h.close()
        path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """JSONL metrics stream (``metrics.jsonl``) and PNG panels (``images/``)."""

    def __init__(self, output_dir: str | Path):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._warned_no_matplotlib = False

    def scalars(self, step: int, **values: float) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def image(self, step: int, tag: str, img) -> None:
        """Write an image panel as images/<tag>_<step>.png (viridis for 2-D
        float maps, clipped to [0, 1])."""
        try:
            import matplotlib
        except ImportError:
            if not self._warned_no_matplotlib:
                self._warned_no_matplotlib = True
                logging.getLogger(LOGGER).warning(
                    "matplotlib is not installed: image panels are not written")
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        arr = np.asarray(img)
        png_dir = self.dir / "images"
        png_dir.mkdir(exist_ok=True)
        a2 = arr if arr.ndim in (2, 3) else arr.reshape(arr.shape[-2:])
        plt.imsave(
            png_dir / f"{tag}_{int(step):06d}.png",
            np.clip(a2, 0, 1) if a2.dtype != np.uint8 else a2,
            cmap="viridis" if a2.ndim == 2 else None,
        )

    def close(self) -> None:
        self._f.close()
