"""The plain reference of the soft silhouette, the mask loss and its
gradient, in float64 PyTorch.

Semantics (those the configurations state, not how any kernel computes
them): every triangle of the arm is projected through the OpenCV pinhole K
under camera-from-link poses; it counts when all three corners lie in
(near, far), its screen area is not degenerate and, with back-face culling,
its outward normal faces the camera. A pixel centre (x + 0.5, y + 0.5) gets
from a triangle the coverage clamp(0.5 + s·dmin, 0, 1), dmin the least of
its three signed, normalised edge distances (positive inside) and of its
distances to the triangle's bbox sides; the silhouette is clamp(Σ coverage,
0, 1) over the triangles, and the loss of a capture set is the mean over
frames of Σ_pixels (silhouette − mask)².

Coverage is zero outside a triangle's bbox dilated by 0.5/s, so each
triangle is evaluated only at the pixels of that dilated bbox (``_pairs``):
blocks of triangles, padded to the block's largest window, scattered into
the frame. Nothing here imports the program; ``prec="tf32"`` rounds the
operands of the two matrix products (camera-from-link poses, corner
transforms) to TF32, the control of how precise the program has to be.
"""
from __future__ import annotations

import torch

from .geometry import se3_exp

F64 = torch.float64
NEAR, FAR = 0.001, 10.0
_EDGES = ((0, 1), (1, 2), (2, 0))
PAIRS_PER_BLOCK = 1 << 21


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits, round half away from
    zero), with the gradient passed straight through."""
    b = x.detach().to(torch.float32).view(torch.int32)
    r = ((b + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)
    return x + (r - x).detach()


class Scene:
    """Static data of one configuration's renderer: link-frame triangle
    corners [F, 3, 3], their link index [F], the image size, K, the
    sharpness and the back-face cull."""

    def __init__(self, corners, link_id, H, W, K, cull=True, sharpness=1.0, device="cpu"):
        self.corners = torch.as_tensor(corners, dtype=F64, device=device)
        self.link_id = torch.as_tensor(link_id, dtype=torch.long, device=device)
        self.H, self.W = int(H), int(W)
        self.K = torch.as_tensor(K, dtype=F64, device=device)
        self.cull, self.s = bool(cull), float(sharpness)
        self.device = torch.device(device)


def project(sc: Scene, Tc, lp, prec=None):
    """Screen triangles of frames lp [B, L, 4, 4] (base-from-link) under
    Tc [4, 4] or [B, 4, 4] (camera-from-base): (u, v [B, F, 3], valid [B, F])."""
    Tc = torch.as_tensor(Tc, dtype=F64, device=sc.device)
    lp = torch.as_tensor(lp, dtype=F64, device=sc.device)
    c = sc.corners
    if prec == "tf32":
        Tc, lp, c = tf32(Tc), tf32(lp), tf32(c)
    M = Tc[..., None, :, :] @ lp if Tc.dim() == 3 else Tc @ lp  # [B, L, 4, 4]
    if prec == "tf32":
        M = tf32(M)
    M = M[:, sc.link_id]  # [B, F, 4, 4]
    X = torch.einsum("bfij,fcj->bfci", M[..., :3, :3], c) + M[..., None, :3, 3]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    K = sc.K
    u = K[0, 0] * x / z + K[0, 2]
    v = K[1, 1] * y / z + K[1, 2]
    valid = ((z > NEAR) & (z < FAR)).all(-1)
    area2 = ((u[..., 1] - u[..., 0]) * (v[..., 2] - v[..., 0])
             - (v[..., 1] - v[..., 0]) * (u[..., 2] - u[..., 0]))
    valid &= area2.abs() > 1e-12
    if sc.cull:
        e1, e2 = X[..., 1, :] - X[..., 0, :], X[..., 2, :] - X[..., 0, :]
        valid &= (torch.linalg.cross(e1, e2, dim=-1) * X[..., 0, :]).sum(-1) < 0
    return u, v, valid


def _windows(sc: Scene, u, v):
    """Per triangle of one frame: the pixel window [x0, x1] × [y0, y1]
    (inclusive, clipped to the image) that holds every pixel centre inside
    its bbox dilated by the soft band 0.5/s."""
    band = 0.5 / sc.s
    with torch.no_grad():
        x0 = torch.floor(u.amin(-1) - band - 0.5).clamp(min=0)
        x1 = torch.ceil(u.amax(-1) + band - 0.5).clamp(max=sc.W - 1)
        y0 = torch.floor(v.amin(-1) - band - 0.5).clamp(min=0)
        y1 = torch.ceil(v.amax(-1) + band - 0.5).clamp(max=sc.H - 1)
    return x0.long(), y0.long(), (x1 - x0 + 1).long().clamp(min=0), (y1 - y0 + 1).long().clamp(min=0)


def _blocks(wx, wy):
    """Triangle index blocks, by window area, of at most PAIRS_PER_BLOCK
    padded pairs each: [(ids, max wx, max wy)]."""
    area = wx * wy
    order = torch.argsort(area)
    keep = order[area[order] > 0]
    out, i = [], 0
    wx_h, wy_h = wx[keep].tolist(), wy[keep].tolist()
    n = len(wx_h)
    while i < n:
        j, mx, my = i, 0, 0
        while j < n:
            nx, ny = max(mx, wx_h[j]), max(my, wy_h[j])
            if j > i and (j - i + 1) * nx * ny > PAIRS_PER_BLOCK:
                break
            mx, my, j = nx, ny, j + 1
        out.append((keep[i:j], mx, my))
        i = j
    return out


def _coverage_frame(sc: Scene, u, v, valid):
    """Σ coverage [H·W] of one frame's triangles u, v [F, 3]."""
    u, v = u[valid], v[valid]
    acc = torch.zeros(sc.H * sc.W, dtype=F64, device=sc.device)
    if u.shape[0] == 0:
        return acc
    area2 = (u[:, 1] - u[:, 0]) * (v[:, 2] - v[:, 0]) - (v[:, 1] - v[:, 0]) * (u[:, 2] - u[:, 0])
    orient = torch.where(area2 >= 0, 1.0, -1.0).to(F64)
    edges = []
    for ia, ib in _EDGES:
        p = v[:, ia] - v[:, ib]
        q = u[:, ib] - u[:, ia]
        inv = orient / torch.clamp(torch.sqrt(p * p + q * q), min=1e-12)
        a, b = p * inv, q * inv
        edges.append((a, b, -(a * u[:, ia] + b * v[:, ia])))
    lo_x, hi_x = u.amin(-1), u.amax(-1)
    lo_y, hi_y = v.amin(-1), v.amax(-1)
    x0, y0, wx, wy = _windows(sc, u, v)
    parts = []
    for ids, mx, my in _blocks(wx, wy):
        ox = torch.arange(mx, device=sc.device)
        oy = torch.arange(my, device=sc.device)
        X = x0[ids, None, None] + ox[None, None, :]
        Y = y0[ids, None, None] + oy[None, :, None]
        inside = (ox[None, None, :] < wx[ids, None, None]) & (oy[None, :, None] < wy[ids, None, None])
        px, py = X.to(F64) + 0.5, Y.to(F64) + 0.5

        def r(t):
            return t[ids, None, None]

        d = [r(a) * px + r(b) * py + r(c) for a, b, c in edges]
        dbb = torch.minimum(torch.minimum(px - r(lo_x), r(hi_x) - px),
                            torch.minimum(py - r(lo_y), r(hi_y) - py))
        dmin = torch.minimum(torch.minimum(torch.minimum(d[0], d[1]), d[2]), dbb)
        cov = torch.clamp(0.5 + sc.s * dmin, 0.0, 1.0)
        parts.append(((Y * sc.W + X)[inside], cov[inside]))
    if parts:
        idx = torch.cat([p[0] for p in parts])
        acc = acc.index_add(0, idx, torch.cat([p[1] for p in parts]))
    return acc


def silhouette(sc: Scene, Tc, lp, prec=None) -> torch.Tensor:
    """[B, H, W] soft silhouettes of frames lp [B, L, 4, 4] under Tc."""
    u, v, valid = project(sc, Tc, lp, prec)
    return torch.stack([torch.clamp(_coverage_frame(sc, u[b], v[b], valid[b]), 0.0, 1.0)
                        for b in range(u.shape[0])]).reshape(-1, sc.H, sc.W)


def loss_and_grad(sc: Scene, dof, lp, masks, prec=None, grad=True):
    """(loss, d loss / d dof [6]) of the capture set at twist dof, in
    float64; frame by frame, so the pairs of one frame are held at a time."""
    lp = torch.as_tensor(lp, dtype=F64, device=sc.device)
    masks = torch.as_tensor(masks, dtype=F64, device=sc.device).reshape(lp.shape[0], -1)
    d = torch.as_tensor(dof, dtype=F64, device=sc.device).detach().requires_grad_(grad)
    B = lp.shape[0]
    total = torch.zeros((), dtype=F64, device=sc.device)
    g = torch.zeros(6, dtype=F64, device=sc.device)
    for b in range(B):
        with torch.set_grad_enabled(grad):
            u, v, valid = project(sc, se3_exp(d), lp[b:b + 1], prec)
            sil = torch.clamp(_coverage_frame(sc, u[0], v[0], valid[0]), 0.0, 1.0)
            lb = ((sil - masks[b]) ** 2).sum() / B
        if grad:
            (gb,) = torch.autograd.grad(lb, d)
            g += gb
        total += lb.detach()
    return float(total), g.cpu().numpy()
