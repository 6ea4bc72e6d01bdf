"""The calibration step's pose math on the card: the kernels of ``csrc/step.cu``
around the fused loss kernels, behind models/calib.py::_Scan's kernel route.

Replaces no Pallas kernel: the JAX package leaves the scan body's pose math
to XLA's fusion (easyhec_tpu/models/calib.py). In PyTorch the same work was
~340 small kernels a step; it moves a few KB, so launch latency bounds it
and three kernels do it. Each has a plain PyTorch twin here, which the
dispatch takes for CPU tensors:

- ``step_head``: Tc = exp(dof) [4, 4] (geometry/se3.py), the kernel camera
  rows cam [B, 16] (render/fused.py::cam_rows), the Jacobian
  d Tc[:3,:4] / d dof [12, 6] and, with probes, their pixels [P, 2];
- ``step_grad``: [loss, g] (7 floats) from the fused forward's loss
  partials, the empty tiles' sum of ref² (compact states), the frame
  weights, the backward's pose partials and the Jacobian;
- ``step_update``: make_optimizer's update of the bare pose (solver/optim.py)
  after the division by ``den``, the traces at the step index, the new pose,
  the step index and the next step's rebin flag.

Each CUDA wrapper counts its launches in ``.launches`` (ops.pose_raster.COUNTED).
"""
from __future__ import annotations

import torch

from ..geometry import se3, so3
from . import _build
from .pose_raster import _F, _I, _P, _stream, check_tensor, count_launches, dispatch, raise_on

__all__ = [
    "step_head",
    "step_grad",
    "step_update",
    "grad_workspace",
    "project_probes",
    "exp_jacobian",
    "step_head_cuda",
    "step_grad_cuda",
    "step_update_cuda",
    "step_head_plain",
    "step_grad_plain",
    "step_update_plain",
]

_DEPTH_MIN = 0.05  # the drift probes' depth clamp


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def project_probes(probes: torch.Tensor, T: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """[P, 2] pixels of base-frame probes [P, 3] under the pose T [4, 4] and
    intrinsics K (depth clamped at 0.05)."""
    pc = probes @ T[:3, :3].T + T[:3, 3]
    z = torch.clamp(pc[:, 2], min=_DEPTH_MIN)
    return torch.stack([K[0, 0] * pc[:, 0] / z + K[0, 2], K[1, 1] * pc[:, 1] / z + K[1, 2]],
                       dim=-1)


def _coeffs(t2: torch.Tensor):
    """se3._V_coeffs' A, B, C of θ² and their derivatives in θ²: the closed
    forms' derivatives, or below θ = 0.2 the derivatives of the same
    three-term series."""
    small = t2 < 0.04
    ts = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(ts)
    s, c = torch.sin(th), torch.cos(th)
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, s / th)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - c) / ts)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (th - s) / (ts * th))
    dA = torch.where(small, -1.0 / 6.0 + t2 * (2.0 / 120.0), (c - A) / (2.0 * ts))
    dB = torch.where(small, -1.0 / 24.0 + t2 * (2.0 / 720.0), (A - 2.0 * B) / (2.0 * ts))
    dC = torch.where(small, -1.0 / 120.0 + t2 * (2.0 / 5040.0), (B - 3.0 * C) / (2.0 * ts))
    return A, B, C, dA, dB, dC


def exp_jacobian(dof: torch.Tensor) -> torch.Tensor:
    """[12, 6] d se3.exp(dof)[:3, :4] / d dof, row 4 i + j. With R = I + A W
    + B W² and t = v + B (w × v) + C (w (w·v) − θ² v), A, B, C functions of
    θ² (d θ² / d w_k = 2 w_k) and d W² / d w_k = e_k wᵀ + w e_kᵀ − 2 w_k I."""
    v, w = dof[:3], dof[3:]
    t2 = torch.sum(w * w)
    A, B, C, dA, dB, dC = _coeffs(t2)
    eye = torch.eye(3, dtype=dof.dtype, device=dof.device)
    W = so3.hat(w)
    W2 = torch.outer(w, w) - t2 * eye
    wxv = torch.linalg.cross(w, v, dim=-1)
    wdv = torch.sum(w * v)
    E = so3.hat(eye)  # [k, i, j]: hat(e_k)
    dW2 = (eye[:, :, None] * w[None, None, :] + w[None, :, None] * eye[:, None, :]
           - 2.0 * w[:, None, None] * eye[None])  # [k, i, j]
    s2 = 2.0 * w
    dR = (A * E + B * dW2 + s2[:, None, None] * (dA * W + dB * W2)[None])  # [k, i, j]
    ekxv = E @ v  # [k, i]
    dt_w = (B * ekxv + C * (eye * wdv + w[None, :] * v[:, None] - s2[:, None] * v[None, :])
            + s2[:, None] * (dB * wxv + dC * (w * wdv - t2 * v))[None, :])  # [k, i]
    dt_v = eye + B * W + C * W2  # [i, m]
    J = torch.zeros((3, 4, 6), dtype=dof.dtype, device=dof.device)
    J[:, :3, 3:] = dR.permute(1, 2, 0)
    J[:, 3, :3] = dt_v
    J[:, 3, 3:] = dt_w.T
    return J.reshape(12, 6)


def step_head_plain(dof, K, Tc, cam, jac, probes=None, pix=None) -> None:
    """In place: Tc [4, 4] = se3.exp(dof), cam [B, 16] its kernel camera
    rows (Tc[:3,:4] row-major, fx fy cx cy), jac [12, 6] = exp_jacobian(dof)
    and, with probes [P, 3], pix [P, 2] their pixels under Tc."""
    T = se3.exp(dof)
    Tc.copy_(T)
    kvec = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    cam.copy_(torch.cat([T[:3, :4].reshape(12), kvec]).expand_as(cam))
    jac.copy_(exp_jacobian(dof))
    if probes is not None:
        pix.copy_(project_probes(probes, T, K))


_MAX_SPLITS = 16  # blocks a frame of step_grad_cuda
_SPLIT_ITEMS = 1024  # the elements a block of 256 threads takes at the least


def _splits(nb: int, ns: int, T: int) -> int:
    """Blocks a frame for step_grad_cuda: about _SPLIT_ITEMS of its largest
    input each (a shape's constant, so the sums' order is too)."""
    return max(1, min(_MAX_SPLITS, -(-max(nb, ns, T) // _SPLIT_ITEMS)))


def grad_workspace(B: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """step_grad's scratch on the card: a row of 13 per block (up to
    _MAX_SPLITS blocks a frame) and the int32 ticket (zero; the kernel leaves
    it zero). Allocated once per scan."""
    return (torch.empty((B * _MAX_SPLITS, 13), dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def step_grad_plain(parts, lparts, counts, ref_sq, w, jac, out, work=None) -> None:
    """In place: out [7] = [Σ_b w_b (Σ lparts[b] + Σ_t [counts = 0] ref_sq[b]),
    J^T Σ parts]. parts [B, nb, 12] (already weighted: the backward took w as
    its cotangent), lparts [B, ...] the forward's loss partials, counts and
    ref_sq [B, T] or None (the dense forward sums its empty tiles itself), w
    [B], jac [12, 6]. ``work`` is the kernel's."""
    B = w.shape[0]
    per_frame = lparts.reshape(B, -1).sum(dim=-1)
    if counts is not None:
        per_frame = per_frame + torch.where(counts == 0, ref_sq,
                                            torch.zeros_like(ref_sq)).sum(dim=-1)
    dtc = parts.reshape(B, -1, 12).sum(dim=1).sum(dim=0)
    out[0] = torch.sum(per_frame * w)
    out[1:] = dtc @ jac


def step_update_plain(gl, den, opt, leaves, dof, losses, history, idx, need, inner,
                      drift=None) -> None:
    """In place, as models/calib.py::_Scan's autograd step finishes: loss, g =
    gl / den; opt.update (make_optimizer's, over the bare dof); losses[idx] =
    loss, history[idx] = dof before the update; dof += update; the leaves;
    idx += 1; need = the drift test (drift = (probes [P, 3], K, pix [P, 2],
    budget): the probes' largest pixel move under exp(dof) past the budget)
    or, without drift, idx % inner == 0."""
    buf = gl / den
    updates, st = opt.update(buf[1:], opt.from_leaves(leaves), dof)
    losses.index_copy_(0, idx, buf[:1])
    history.index_copy_(0, idx, dof[None])
    dof.copy_(dof + updates)
    for b, leaf in zip(leaves, opt.leaves(st)):
        b.copy_(leaf)
    idx += 1
    if drift is not None:
        probes, K, pix, budget = drift
        moved = torch.max(torch.abs(project_probes(probes, se3.exp(dof), K) - pix))
        torch.gt(moved, budget, out=need)
    else:
        torch.eq(torch.remainder(idx[0], inner), 0, out=need)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/step.cu), bound with ctypes
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("step")
    if not getattr(lib, "_easyhec_typed", False):
        lib.easyhec_step_head.argtypes = [_P] * 7 + [_I] * 2 + [_P]
        lib.easyhec_step_head.restype = _I
        lib.easyhec_step_grad.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib.easyhec_step_grad.restype = _I
        lib.easyhec_step_update.argtypes = (
            [_P, _F, _I] + [_F] * 9 + [_P, _F] + [_P] * 10 + [_P] * 3 + [_F, _I, _P]
        )
        lib.easyhec_step_update.restype = _I
        lib._easyhec_typed = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def step_head_cuda(dof, K, Tc, cam, jac, probes=None, pix=None) -> None:
    """step_head_plain on the card: one block."""
    dev = dof.device
    f32 = torch.float32
    B = cam.shape[0]
    check_tensor("dof", dof, f32, (6,), dev)
    check_tensor("K", K, f32, (3, 3), dev)
    check_tensor("Tc", Tc, f32, (4, 4), dev)
    check_tensor("cam", cam, f32, (B, 16), dev)
    check_tensor("jac", jac, f32, (12, 6), dev)
    P = 0
    if probes is not None:
        P = probes.shape[0]
        check_tensor("probes", probes, f32, (P, 3), dev)
        check_tensor("pix", pix, f32, (P, 2), dev)
    err = _lib().easyhec_step_head(dof.data_ptr(), K.data_ptr(), Tc.data_ptr(), cam.data_ptr(),
                                   jac.data_ptr(), _ptr(probes), _ptr(pix), B, P, _stream(dev))
    raise_on(err, "step head kernel")
    step_head_cuda.launches += 1


def step_grad_cuda(parts, lparts, counts, ref_sq, w, jac, out, work) -> None:
    """step_grad_plain on the card: a few blocks a frame (_splits), the last
    to finish summing their rows in a fixed order."""
    dev = w.device
    f32 = torch.float32
    B = w.shape[0]
    nb = parts.shape[1]
    ns = lparts[0].numel() if B else 0
    check_tensor("parts", parts, f32, (B, nb, 12), dev)
    if parts.data_ptr() % 16:
        raise ValueError("parts: the kernel reads its rows as float4, 16-byte aligned")
    check_tensor("lparts", lparts, f32, tuple(lparts.shape), dev)
    if lparts.shape[0] != B:
        raise ValueError(f"lparts: {lparts.shape[0]} frames, not {B}")
    T = 0
    if counts is not None:
        T = counts.shape[1]
        check_tensor("counts", counts, torch.int32, (B, T), dev)
        check_tensor("ref_sq", ref_sq, f32, (B, T), dev)
    check_tensor("w", w, f32, (B,), dev)
    check_tensor("jac", jac, f32, (12, 6), dev)
    check_tensor("out", out, f32, (7,), dev)
    scratch, ticket = work
    check_tensor("scratch", scratch, f32, (B * _MAX_SPLITS, 13), dev)
    check_tensor("ticket", ticket, torch.int32, (1,), dev)
    err = _lib().easyhec_step_grad(
        parts.data_ptr(), lparts.data_ptr(), _ptr(counts), _ptr(ref_sq), w.data_ptr(),
        jac.data_ptr(), scratch.data_ptr(), ticket.data_ptr(), out.data_ptr(), B, nb, ns, T,
        _splits(nb, ns, T), _stream(dev))
    raise_on(err, "step grad kernel")
    step_grad_cuda.launches += 1


def step_update_cuda(gl, den, opt, leaves, dof, losses, history, idx, need, inner,
                     drift=None) -> None:
    """step_update_plain on the card (one block), for an optimizer with a
    kernel spec (solver.optim.OptSpec). A schedule other than ``constant``
    keeps its PyTorch code: its lr, at the schedule's count, is a device
    scalar the kernel reads."""
    dev = gl.device
    f32, i32 = torch.float32, torch.int32
    spec = opt.spec
    if spec is None:
        raise ValueError("step_update_cuda needs make_optimizer's adam or sgd over one tensor")
    check_tensor("gl", gl, f32, (7,), dev)
    check_tensor("dof", dof, f32, (6,), dev)
    n = losses.shape[0]
    check_tensor("losses", losses, f32, (n,), dev)
    check_tensor("history", history, f32, (n, 6), dev)
    check_tensor("idx", idx, torch.int64, (1,), dev)
    check_tensor("inner", inner, torch.int64, (), dev)
    check_tensor("need", need, torch.bool, (), dev)
    if spec.adam:
        count, mu, nu, sched = leaves
        check_tensor("count", count, i32, (), dev)
        check_tensor("nu", nu, f32, (6,), dev)
    else:
        (mu, sched), count, nu = leaves, None, None
    check_tensor("mu", mu, f32, (6,), dev)
    check_tensor("sched", sched, i32, (), dev)
    lr = spec.lr if spec.lr is not None else spec.sched(sched)
    lr_t = None
    if torch.is_tensor(lr):
        lr_t, lr = lr.to(f32).reshape(()).contiguous(), 0.0
    probes = K = pix = None
    budget, P = 0.0, 0
    if drift is not None:
        probes, K, pix, budget = drift
        P = probes.shape[0]
        check_tensor("probes", probes, f32, (P, 3), dev)
        check_tensor("pix", pix, f32, (P, 2), dev)
        check_tensor("K", K, f32, (3, 3), dev)
    err = _lib().easyhec_step_update(
        gl.data_ptr(), float(den), int(spec.adam), spec.b1, 1.0 - spec.b1, spec.b2,
        1.0 - spec.b2, spec.eps, spec.momentum, spec.grad_clip, spec.grad_clip_value,
        spec.weight_decay, _ptr(lr_t), float(lr), _ptr(count), mu.data_ptr(), _ptr(nu),
        sched.data_ptr(), dof.data_ptr(), losses.data_ptr(), history.data_ptr(),
        idx.data_ptr(), inner.data_ptr(), need.data_ptr(), _ptr(probes), _ptr(pix), _ptr(K),
        float(budget), P, _stream(dev))
    raise_on(err, "step update kernel")
    step_update_cuda.launches += 1


count_launches(step_head_cuda, step_grad_cuda, step_update_cuda)


def step_head(*args) -> None:
    dispatch(step_head_cuda, step_head_plain, *args)


def step_grad(*args) -> None:
    dispatch(step_grad_cuda, step_grad_plain, *args)


def step_update(*args) -> None:
    dispatch(step_update_cuda, step_update_plain, *args)
