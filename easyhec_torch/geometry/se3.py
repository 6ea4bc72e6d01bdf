"""SE(3) exponential / logarithm maps and rigid-transform helpers.

Torch counterpart of easyhec_tpu/geometry/se3.py, same convention: plain
column-vector homogeneous 4×4, ``T = [[R, t], [0, 1]]``, twist
``xi = [v(3), w(3)]`` with ``R = exp(w)`` and ``t = V(w) @ v``.
"""
from __future__ import annotations

import torch

from . import so3

__all__ = ["exp", "log", "inverse", "from_rt"]


def _V_coeffs(theta2: torch.Tensor):
    """Coefficients for V = I + B·W + C·W², V⁻¹ = I - W/2 + D·W².

    B = (1-cosθ)/θ², C = (θ-sinθ)/θ³, D = (1 - A/(2B))/θ² with A=sinθ/θ.

    The Taylor branch covers θ < 0.2, not just θ→0: the closed forms cancel
    catastrophically in float32 well before underflow (at θ=1e-3 the old
    θ<1e-4 switch gave 0.03 absolute error in log-translation; PARITY.md).
    Three series terms keep truncation below f32 eps up to θ=0.2.
    """
    small = theta2 < 0.04  # θ < 0.2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    t2 = theta2
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, sin_t / theta)
    B = torch.where(
        small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - cos_t) / theta2_safe
    )
    C = torch.where(
        small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
        (theta - sin_t) / (theta2_safe * theta),
    )
    D = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
        (1.0 - 0.5 * A / B) / theta2_safe,
    )
    return A, B, C, D


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: twist [..., 6] (v, w) -> [..., 4, 4] transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    A, B, C, _ = _V_coeffs(theta2)
    W = so3.hat(w)
    W2 = so3._hat_sq(w, theta2)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    # t = V v with V = I + B·W + C·W²:  t = v + B (w×v) + C (w(w·v) − θ² v)
    wxv = torch.linalg.cross(w, v, dim=-1)
    wdotv = torch.sum(w * v, dim=-1, keepdim=True)
    t = v + B[..., None] * wxv + C[..., None] * (w * wdotv - theta2[..., None] * v)
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: [..., 4, 4] -> twist [..., 6] (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3.log(R)
    theta2 = torch.sum(w * w, dim=-1)
    _, _, _, D = _V_coeffs(theta2)
    # v = V⁻¹ t with V⁻¹ = I − W/2 + D·W²:  v = t − (w×t)/2 + D (w(w·t) − θ² t)
    wxt = torch.linalg.cross(w, t, dim=-1)
    wdott = torch.sum(w * t, dim=-1, keepdim=True)
    v = t - 0.5 * wxt + D[..., None] * (w * wdott - theta2[..., None] * t)
    return torch.cat([v, w], dim=-1)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse via Rᵀ."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, t)
    return from_rt(Rt, t_inv)
