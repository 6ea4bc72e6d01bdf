"""SO(3) maps: hat/vee, exponential and logarithm, rotation utilities.

Torch counterpart of easyhec_tpu/geometry/so3.py: the same closed forms,
branch-free (``torch.where`` on Taylor-safe expressions) so they batch over
any leading axes and differentiate with autograd.

Convention: column vectors, ``R @ x``; angle-axis vector ``w`` with θ = |w|.
"""
from __future__ import annotations

import math

import torch

__all__ = ["hat", "vee", "exp", "log", "rotx", "roty", "rotz"]


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix, hat(w) @ x = w × x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] skew matrix -> [..., 3] vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """A = sin(θ)/θ and B = (1-cos(θ))/θ² with Taylor branches for θ < 0.2
    (the closed forms cancel in f32 well before θ→0; see se3._V_coeffs)."""
    small = theta2 < 0.04
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(
        small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
        torch.sin(theta) / theta,
    )
    B = torch.where(
        small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
        (1.0 - torch.cos(theta)) / theta2_safe,
    )
    return A, B


def _hat_sq(w: torch.Tensor, theta2: torch.Tensor) -> torch.Tensor:
    """hat(w)² = w wᵀ − θ² I, as an outer product."""
    outer = w[..., :, None] * w[..., None, :]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(outer.shape)
    return outer - theta2[..., None, None] * eye


def exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map (Rodrigues): [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = _hat_sq(w, theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: [..., 3, 3] -> [..., 3] angle-axis (|w| ≤ π).

    Two well-conditioned regimes, selected per element:
    - θ ≤ π/2: w = θ/(2 sinθ) · vee(R − Rᵀ), Taylor near 0.
    - θ > π/2: axis from the symmetric part, aᵢ² = (Rᵢᵢ − cosθ)/(1 − cosθ),
      signs from off-diagonal products and the skew part; θ from |skew|.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    skew = vee(R - R.transpose(-1, -2))  # = 2 sinθ · axis

    small = theta < 1e-4
    use_sym = theta > (math.pi / 2)
    sin_theta = torch.sin(theta)
    sin_safe = torch.where(small | use_sym, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(
        small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe)
    )
    w_skew = scale[..., None] * skew

    one_minus_cos = torch.where(
        use_sym, 1.0 - cos_theta, torch.ones_like(cos_theta)
    )
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(
        torch.clamp((diag - cos_theta[..., None]) / one_minus_cos[..., None], min=0.0)
    )
    m01 = R[..., 0, 1] + R[..., 1, 0]
    m02 = R[..., 0, 2] + R[..., 2, 0]
    m12 = R[..., 1, 2] + R[..., 2, 1]
    one = torch.ones_like(m01)
    prod = torch.stack(
        [
            torch.stack([one, m01, m02], dim=-1),
            torch.stack([m01, one, m12], dim=-1),
            torch.stack([m02, m12, one], dim=-1),
        ],
        dim=-2,
    )
    k = torch.argmax(axis_abs, dim=-1)
    rel = torch.gather(
        prod, -2, k[..., None, None].expand(k.shape + (1, 3))
    )[..., 0, :]
    signs = torch.where(rel < 0, -torch.ones_like(rel), torch.ones_like(rel))
    axis_sym = axis_abs * signs
    align = torch.sum(axis_sym * skew, dim=-1, keepdim=True)
    axis_sym = torch.where(align < 0, -axis_sym, axis_sym)
    sin_from_skew = torch.clamp(
        0.5 * torch.sqrt(torch.sum(skew * skew, dim=-1)), 0.0, 1.0
    )
    theta_sym = math.pi - torch.arcsin(sin_from_skew)
    w_sym = theta_sym[..., None] * axis_sym
    return torch.where(use_sym[..., None], w_sym, w_skew)


def _rot(a, rows):
    a = torch.as_tensor(a, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    env = {"c": c, "s": s, "-s": -s, "z": z, "o": o}
    return torch.stack(
        [torch.stack([env[n] for n in r], -1) for r in rows], -2
    )


def rotx(a):
    return _rot(a, (("o", "z", "z"), ("z", "c", "-s"), ("z", "s", "c")))


def roty(a):
    return _rot(a, (("c", "z", "s"), ("z", "o", "z"), ("-s", "z", "c")))


def rotz(a):
    return _rot(a, (("c", "-s", "z"), ("s", "c", "z"), ("z", "z", "o")))
