"""Counting-sort tile binning on the card: the kernels of ``csrc/binning.cu``
behind render/binning.py::bin_count for CUDA tensors.

Replaces no Pallas kernel: the JAX package bins with XLA
(easyhec_tpu/render/binning.py::bin_count). The plain version is
render/binning.py::_bin_count_flat, which ``bin_count`` takes for CPU
tensors: it enumerates a static window of (triangle, tile) entries per
triangle, keys the unused ones with a sentinel and sorts them all. The
kernels enumerate only the real entries and rank them without a sort; idx,
counts, q and overflow equal the plain version's bit for bit (the contract
is written out at the top of the source). ``bin_count_cuda`` counts its
calls, four kernels each, in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .pose_raster import _I, _P, _ptr, _stream, check_tensor, count_launches, raise_on

__all__ = ["bin_count_cuda"]


def _lib():
    lib = _build.load("binning")
    if not getattr(lib, "_easyhec_typed", False):
        lib.easyhec_bin_count.argtypes = [_P] * 11 + [_I] * 10 + [_P]
        lib.easyhec_bin_count.restype = _I
        lib.easyhec_bin_scratch_ints.argtypes = [_I] * 11
        lib.easyhec_bin_scratch_ints.restype = ctypes.c_longlong
        lib._easyhec_typed = True
    return lib


def bin_count_cuda(lox, loy, hix, hiy, valid, suby, H, W, th, tw, cap, ry, rx, big_k):
    """bin_count over a flat [B, F] batch on the card: bboxes f32, valid
    bool, suby f32 or None -> (idx [B, K, cap], counts [B, K], q [B, F, R]
    int32, overflow [B] bool), K the th x tw tiles of H x W and R = ry*rx,
    or min(2, ry) + ry*rx with big_k > 0 (binning.BinState's fields)."""
    B, F = valid.shape
    dev = valid.device
    ins = [a.contiguous() for a in (lox, loy, hix, hiy)]
    for name, a in zip(("lox", "loy", "hix", "hiy"), ins):
        check_tensor(name, a, torch.float32, (B, F), dev)
    valid = valid.contiguous()
    check_tensor("valid", valid, torch.bool, (B, F), dev)
    if suby is not None:
        suby = suby.contiguous()
        check_tensor("suby", suby, torch.float32, (B, F), dev)
    dims = [int(v) for v in (H, W, th, tw, cap, ry, rx, big_k)]
    lib = _lib()
    n = lib.easyhec_bin_scratch_ints(B, F, *dims, int(suby is not None))
    if n < 0:
        raise ValueError(f"bin_count kernels: no launch for B={B}, F={F}, H, W, tile, cap, "
                         f"rect, big_k = {dims}")
    H, W, th, tw, cap, ry, rx, big_k = dims
    K = (-(-H // th)) * (-(-W // tw))
    R = ry * rx + (min(2, ry) if big_k > 0 else 0)
    i32 = dict(dtype=torch.int32, device=dev)
    idx = torch.empty((B, K, cap), **i32)
    counts = torch.empty((B, K), **i32)
    q = torch.empty((B, F, R), **i32)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    scratch = torch.empty((n,), **i32)
    err = lib.easyhec_bin_count(
        *(a.data_ptr() for a in ins), valid.data_ptr(), _ptr(suby), idx.data_ptr(),
        counts.data_ptr(), q.data_ptr(), overflow.data_ptr(), scratch.data_ptr(),
        B, F, *dims, _stream(dev),
    )
    raise_on(err, "bin_count kernels")
    bin_count_cuda.launches += 1
    return idx, counts, q, overflow


count_launches(bin_count_cuda)
