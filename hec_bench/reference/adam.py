"""Adam as the configurations state it (optax's defaults: b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias-corrected, a constant rate): its
first update, in float64 NumPy."""
from __future__ import annotations

import numpy as np

EPS = 1e-8


def first_step(g, lr: float) -> np.ndarray:
    """The update of Adam's first step from zero moments: bias-corrected,
    m = g and v = g * g, so -lr * g / (|g| + eps)."""
    g = np.asarray(g, np.float64)
    return -lr * g / (np.abs(g) + EPS)
