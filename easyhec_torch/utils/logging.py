"""Logging + metrics sinks.

Counterpart of easyhec_tpu/utils/logging.py: stdlib logging to stdout and
``log.txt``, a JSONL metrics stream with PNG image panels, and optional
TensorBoard scalars and images. The panels are written by
``utils.imaging.write_png`` in matplotlib's colors (no matplotlib needed);
errors in writing them are raised, not swallowed.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

from .imaging import colorize, write_png

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
    """JSONL metrics stream (``metrics.jsonl``), PNG panels (``images/``)
    and, with ``tensorboard``, TensorBoard scalars and images under ``tb/``
    (when TensorBoard is not installed, a warning and none)."""

    def __init__(self, output_dir: str | Path, tensorboard: bool = False):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                logging.getLogger(LOGGER).warning(
                    "TensorBoard is not available (%s): metrics go to "
                    "metrics.jsonl and images/ only", e)
            else:
                self._tb = SummaryWriter(log_dir=str(self.dir / "tb"))

    def scalars(self, step: int, **values: float) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def image(self, step: int, tag: str, img) -> None:
        """Write an image panel as images/<tag>_<step:06d>.png, as
        matplotlib's imsave writes it: a 2-D map (floats clipped to [0, 1])
        in viridis over its own min and max; RGB(A) floats clipped and ·255,
        uint8 RGB(A) as is, the alpha dropped; a map with leading axes of 1
        squeezed. Also to TensorBoard when it is on."""
        arr = np.asarray(img)
        a2 = arr if arr.ndim in (2, 3) else arr.reshape(arr.shape[-2:])
        if a2.dtype != np.uint8:
            a2 = np.clip(a2, 0, 1)
        if a2.ndim == 2:
            rgb = colorize(a2, "viridis")
        elif a2.shape[-1] not in (3, 4):
            raise ValueError(f"image panel {tag!r}: a 3-D array needs 3 or 4 channels, "
                             f"got shape {arr.shape}")
        else:
            rgb = a2[..., :3] if a2.dtype == np.uint8 else (a2[..., :3] * 255).astype(np.uint8)
        png_dir = self.dir / "images"
        png_dir.mkdir(exist_ok=True)
        write_png(png_dir / f"{tag}_{int(step):06d}.png", rgb)
        if self._tb is not None:
            tb_arr = arr
            if tb_arr.ndim == 2:
                tb_arr = tb_arr[None]
            elif tb_arr.ndim == 3 and tb_arr.shape[-1] in (1, 3):
                tb_arr = tb_arr.transpose(2, 0, 1)
            self._tb.add_image(tag, tb_arr, int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
