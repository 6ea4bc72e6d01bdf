"""The fused routes' bin state on the card: the kernels of ``csrc/rebin.cu``
around the binner, behind render/fused.py for CUDA tensors.

Replaces no Pallas kernel: the JAX package builds the bin state with XLA
(easyhec_tpu/render/fused.py). The plain versions are render/fused.py's
``_tri_setup_plain`` and ``_compact_pack_plain``, which the dispatch takes
for CPU tensors; the kernels give their arrays bit for bit.

- ``tri_setup_cuda``: the triangle setup of every fused bin state (dense and
  compact): projection, culls, the margin-dilated bboxes and row centres the
  binner takes, and the base-frame field table the packs read.
- ``compact_pack_cuda``: the compact pack of a CompactState from the
  binner's int32 lists (chunk map, live slots, used chunks, overflow,
  records).

Each counts its calls in ``.launches`` (one per bin state; the pack two
kernels a call).
"""
from __future__ import annotations

import torch

from . import _build
from .pose_raster import CHUNK, POSE_RECORD, _F, _I, _P, _stream, check_tensor, \
    count_launches, raise_on

__all__ = ["tri_setup_cuda", "compact_pack_cuda"]

_EPS_Z = 1e-9  # projection.setup_triangles_corners' eps
_EPS_AREA = 1e-12  # its degenerate-area test


def _lib():
    lib = _build.load("rebin")
    if not getattr(lib, "_easyhec_typed", False):
        lib.easyhec_tri_setup.argtypes = [_P] * 8 + [_I] * 5 + [_F] * 5 + [_P]
        lib.easyhec_tri_setup.restype = _I
        lib.easyhec_compact_pack.argtypes = [_P] * 11 + [_I] * 5 + [_P]
        lib.easyhec_compact_pack.restype = _I
        lib._easyhec_typed = True
    return lib


def tri_setup_cuda(corners_rest, face_link_onehot, face_link_id, Tc_c2l, lp, K, margin,
                   near, far, cull_backfaces, subsort):
    """The triangle setup of a fused bin state on the card: corners_rest
    [3, 4, F], face_link_id [F] (the kernel reads each face's link pose
    directly, which the plain version's product with face_link_onehot [L, F]
    selects exactly), Tc_c2l and lp [B, L, 4, 4] camera- and base-from-link,
    K [3, 3] -> ((lox - m, loy - m, hix + m, hiy + m, suby or None) [B, F]
    f32, valid [B, F] bool, fields [B, 12, F + 1] f32, its last column
    zero)."""
    dev = corners_rest.device
    F = corners_rest.shape[-1]
    B, L = Tc_c2l.shape[:2]
    f32 = torch.float32
    corners = corners_rest.contiguous()
    link = face_link_id.to(torch.int32).contiguous()
    cam = Tc_c2l.contiguous()
    base = lp.contiguous()
    Kc = K.to(f32).contiguous()
    check_tensor("corners_rest", corners, f32, (3, 4, F), dev)
    check_tensor("face_link_id", link, torch.int32, (F,), dev)
    check_tensor("Tc_c2l", cam, f32, (B, L, 4, 4), dev)
    check_tensor("lp", base, f32, (B, L, 4, 4), dev)
    check_tensor("K", Kc, f32, (3, 3), dev)
    if face_link_onehot.shape != (L, F):  # the plain version's product raises here
        raise ValueError(f"face_link_onehot is {tuple(face_link_onehot.shape)}, not the "
                         f"poses' {L} links by {F} faces")
    box = torch.empty((5 if subsort else 4, B, F), dtype=f32, device=dev)
    valid = torch.empty((B, F), dtype=torch.bool, device=dev)
    fields = torch.empty((B, POSE_RECORD, F + 1), dtype=f32, device=dev)
    err = _lib().easyhec_tri_setup(
        corners.data_ptr(), link.data_ptr(), cam.data_ptr(), base.data_ptr(), Kc.data_ptr(),
        box.data_ptr(), valid.data_ptr(), fields.data_ptr(), B, F, L, int(bool(subsort)),
        int(bool(cull_backfaces)), float(margin), float(near), float(far), _EPS_Z, _EPS_AREA,
        _stream(dev),
    )
    raise_on(err, "triangle setup kernel")
    tri_setup_cuda.launches += 1
    return (box[0], box[1], box[2], box[3], box[4] if subsort else None), valid, fields


def compact_pack_cuda(counts, bin_overflow, idx, fields, nc):
    """The compact pack on the card: counts [B, T] and idx [B, T, cap] int32
    and bin_overflow [B] bool (binning.BinState's), fields [B, 12, F + 1]
    (tri_setup_cuda's) -> (rec [B, 12, nc*128] f32, nlive [B, nc], ctmap
    [B, nc], ncu [B] int32, overflow [] bool, cpos [B, nc] int32, the
    identity chunk map of the backward, starts [B, T] int32, each tile's
    first chunk)."""
    dev = counts.device
    B, T = counts.shape
    cap = idx.shape[-1]
    F = fields.shape[-1] - 1
    nc = int(nc)
    i32 = dict(dtype=torch.int32, device=dev)
    check_tensor("counts", counts, torch.int32, (B, T), dev)
    check_tensor("bin_overflow", bin_overflow, torch.bool, (B,), dev)
    check_tensor("idx", idx, torch.int32, (B, T, cap), dev)
    check_tensor("fields", fields, torch.float32, (B, POSE_RECORD, F + 1), dev)
    starts = torch.empty((B, T), **i32)
    rec = torch.empty((B, POSE_RECORD, nc * CHUNK), dtype=torch.float32, device=dev)
    nlive = torch.empty((B, nc), **i32)
    ctmap = torch.empty((B, nc), **i32)
    ncu = torch.empty((B,), **i32)
    cpos = torch.empty((B, nc), **i32)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    err = _lib().easyhec_compact_pack(
        counts.data_ptr(), bin_overflow.data_ptr(), idx.data_ptr(), fields.data_ptr(),
        starts.data_ptr(), rec.data_ptr(), nlive.data_ptr(), ctmap.data_ptr(), ncu.data_ptr(),
        cpos.data_ptr(), overflow.data_ptr(), B, T, cap, F, nc, _stream(dev),
    )
    raise_on(err, "compact pack kernels")
    compact_pack_cuda.launches += 1
    return rec, nlive, ctmap, ncu, overflow, cpos, starts


count_launches(tri_setup_cuda, compact_pack_cuda)
