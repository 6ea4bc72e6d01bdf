"""Array helpers that work on numpy arrays and torch tensors alike.

Torch-package copy of easyhec_tpu/utils/arrays.py (the reference's
pn_utils: to_array, norm, min_max, ptp, random_choice, padded_stack,
stack_or_list). Host-side: everything converts through numpy; code on the
device should use torch directly.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "to_array",
    "min_max",
    "ptp",
    "norm",
    "random_choice",
    "padded_stack",
    "stack_or_list",
]


def to_array(x, dtype=None) -> np.ndarray:
    """Anything (list / numpy / torch tensor, on any device) -> numpy array."""
    if hasattr(x, "detach"):  # torch
        x = x.detach().cpu().numpy()
    out = np.asarray(x)
    return out.astype(dtype) if dtype is not None else out


def min_max(x) -> tuple[float, float]:
    x = to_array(x)
    return float(x.min()), float(x.max())


def ptp(x) -> float:
    lo, hi = min_max(x)
    return hi - lo


def norm(x, axis=-1) -> np.ndarray:
    return np.linalg.norm(to_array(x), axis=axis)


def random_choice(x, n: int, replace: bool = False, rng: np.random.Generator | None = None):
    """Sample n rows of x (axis 0); replace=True when n > len(x)."""
    x = to_array(x)
    rng = rng or np.random.default_rng()
    if n > len(x):
        replace = True
    idx = rng.choice(len(x), size=n, replace=replace)
    return x[idx], idx


def padded_stack(arrays, pad_value=0.0) -> tuple[np.ndarray, np.ndarray]:
    """Stack arrays of differing shapes into one padded batch + valid mask."""
    arrays = [to_array(a) for a in arrays]
    ndim = arrays[0].ndim
    if any(a.ndim != ndim for a in arrays):
        raise ValueError("padded_stack needs equal ndim")
    max_shape = tuple(max(a.shape[d] for a in arrays) for d in range(ndim))
    out = np.full((len(arrays), *max_shape), pad_value, arrays[0].dtype)
    valid = np.zeros((len(arrays), *max_shape), bool)
    for i, a in enumerate(arrays):
        sl = (i,) + tuple(slice(0, s) for s in a.shape)
        out[sl] = a
        valid[sl] = True
    return out, valid


def stack_or_list(values):
    """np.stack when shapes agree, else a plain list."""
    arrays = [to_array(v) for v in values]
    if len({a.shape for a in arrays}) == 1:
        return np.stack(arrays)
    return arrays
