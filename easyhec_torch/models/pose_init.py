"""Initial-pose estimation.

Counterpart of easyhec_tpu/models/pose_init.py. The port carries the
look-at path, ``lookat_init``. ``global_search_init`` (the render-and-score
search) waits for the tiled rasterizer: its scoring renderer runs the
unfused route (K5), ROADMAP.md queue item 12.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera, se3

__all__ = ["lookat_init"]


def lookat_init(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-from-base extrinsic [4, 4] from an eye/target guess."""

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    return se3.inverse(camera.look_at(t(eye), t(target), t(up))).numpy()
