"""Result visualizers, registered by name (``build_visualizer``).

Torch-package counterpart of easyhec_tpu/visualizers/visualizers.py:
``hover_mask`` writes each frame's rendered mask over its RGB image and
one grid panel (the ``validate`` tool's overlays); ``error_mask`` writes a
rendered / reference / |error| triptych per frame. Host-side numpy, PNGs
through utils.imaging.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..registry import VISUALIZERS
from ..utils.imaging import hover_masks_on_imgs, image_grid, save_image

__all__ = ["build_visualizer", "HoverMaskVisualizer", "ErrorMaskVisualizer"]


@VISUALIZERS.register("hover_mask")
class HoverMaskVisualizer:
    """Write per-frame mask-over-RGB overlays and one grid panel."""

    def __init__(self, output_dir: str | Path):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def __call__(self, rgbs: np.ndarray, masks: np.ndarray, tag: str = "overlay") -> Path:
        overlays = hover_masks_on_imgs(rgbs, masks)
        for i, ov in enumerate(overlays):
            save_image(self.output_dir / f"{tag}_{i:04d}.png", ov)
        panel_path = self.output_dir / f"{tag}_grid.png"
        save_image(panel_path, image_grid(overlays))
        return panel_path


@VISUALIZERS.register("error_mask")
class ErrorMaskVisualizer:
    """Rendered / reference / |error| triptych per frame."""

    def __init__(self, output_dir: str | Path):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def __call__(self, outputs: dict, tag: str = "error") -> Path:
        rend = np.asarray(outputs["rendered_masks"])
        ref = np.asarray(outputs["ref_masks"])
        rows = []
        for i in range(rend.shape[0]):
            rows += [rend[i], ref[i], np.abs(rend[i] - ref[i])]
        path = self.output_dir / f"{tag}_grid.png"
        save_image(path, image_grid(rows, cols=3))
        return path


def build_visualizer(name: str, output_dir: str | Path):
    return VISUALIZERS.build(name, output_dir)
