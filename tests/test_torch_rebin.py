"""The rule the compact pack's kernels (easyhec_torch/ops/csrc/rebin.cu)
implement, against the plain version that CPU tensors take
(render/fused.py::_compact_pack_plain).

The kernels run only on the card (tests/test_torch_cuda.py holds them to the
plain build there, bit for bit, at the benchmark cells' shapes). Here the
pack's rule is written out in NumPy as the kernels compute it: a per-tile
scan that lays out each tile's chunks, then padding on the last non-empty
tile (or the last tile), then one gather per live slot from the int32
lists. It must give the plain version's arrays exactly, over budget, on
empty frames and at full tiles.
"""
import numpy as np
import pytest
import torch

from easyhec_torch.ops.pose_raster import CHUNK
from easyhec_torch.render.fused import _compact_pack_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

f32 = np.float32


def _pack_rule(counts, bin_ovf, idx, fields, nc):
    """csrc/rebin.cu's compact_scan_kernel and compact_gather_kernel: counts
    [B, T], bin_ovf [B], idx [B, T, cap], fields [B, 12, F + 1]."""
    B, T = counts.shape
    F = fields.shape[-1] - 1
    rec = np.zeros((B, 12, nc * CHUNK), f32)
    nlive = np.zeros((B, nc), np.int32)
    ctmap = np.zeros((B, nc), np.int32)
    ncu = np.zeros(B, np.int32)
    starts = np.zeros((B, T), np.int32)
    for b in range(B):
        cpt = (counts[b] + CHUNK - 1) // CHUNK
        starts[b] = np.cumsum(cpt) - cpt
        for t in np.flatnonzero(cpt):  # each tile lays out its chunks
            for k in range(cpt[t]):
                if starts[b, t] + k < nc:
                    ctmap[b, starts[b, t] + k] = t
                    nlive[b, starts[b, t] + k] = min(counts[b, t] - k * CHUNK, CHUNK)
        ncu[b] = cpt.sum()
        nonempty = np.flatnonzero(cpt)
        ctmap[b, ncu[b]:] = nonempty[-1] if len(nonempty) else T - 1  # padding
        nlive[b, ncu[b]:] = 0
        for c in range(nc):  # one gather a live slot
            t, n = ctmap[b, c], nlive[b, c]
            slot = (c - starts[b, t]) * CHUNK + np.arange(n)
            f = idx[b, t, slot]
            live = (f >= 0) & (f < F)
            rec[b, :, c * CHUNK + np.arange(n)[live]] = fields[b][:, f[live]].T
    cpos = np.tile(np.arange(nc, dtype=np.int32), (B, 1))
    return rec, nlive, ctmap, ncu, bool(bin_ovf.any() | (ncu > nc).any()), cpos, starts


# name: (B, T, cap, F, nc, share of non-empty tiles, frames left empty, a
#        frame's bin overflow)
PACK_CASES = {
    "plain": (3, 40, 300, 500, 48, 0.4, (), False),
    "empty_frame": (3, 40, 300, 500, 48, 0.4, (1,), False),
    "all_empty": (2, 40, 300, 500, 8, 0.4, (0, 1), False),
    "ncu_over": (3, 40, 300, 500, 20, 0.6, (), False),
    "bin_overflow": (2, 40, 300, 500, 48, 0.4, (), True),
    "last_tile_used": (2, 7, 1000, 500, 64, 1.0, (), False),
    "one_tile": (2, 1, 512, 500, 4, 1.0, (), False),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_compact_pack_rule(case):
    """The pack kernels' rule (a per-tile scan, padding chunks on the last
    non-empty tile or the last tile, a gather per live slot from the int32
    lists, the zero record elsewhere) gives _compact_pack_plain's records,
    chunk map, used chunks, overflow, the backward's identity map and each
    tile's first chunk exactly: over budget (ncu > nc), on empty frames and at full tiles."""
    B, T, cap, F, nc, share, empty, bin_over = PACK_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    used = rng.random((B, T)) < share
    counts = np.where(used, rng.integers(1, cap + 1, (B, T)), 0)
    counts[:, :: 5] = np.where(used[:, ::5], cap, 0)  # full tiles
    counts[list(empty)] = 0
    counts = counts.astype(np.int32)
    idx = np.full((B, T, cap), F, np.int32)
    for b in range(B):
        for t in range(T):
            idx[b, t, :counts[b, t]] = rng.integers(0, F, counts[b, t])
    fields = rng.standard_normal((B, 12, F + 1)).astype(f32)
    fields[..., F] = 0
    bin_ovf = np.zeros(B, bool)
    bin_ovf[-1] = bin_over
    got = _compact_pack_plain(torch.from_numpy(counts), torch.from_numpy(bin_ovf),
                              torch.from_numpy(idx), torch.from_numpy(fields), nc)
    want = _pack_rule(counts, bin_ovf, idx, fields, nc)
    names = ("rec", "nlive", "ctmap", "ncu", "overflow", "cpos", "starts")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.dtype == (torch.float32 if name == "rec" else
                           torch.bool if name == "overflow" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    ncu = want[3]
    assert want[4] == (case in ("ncu_over", "bin_overflow"))
    assert (ncu > nc).any() == (case == "ncu_over")
    assert (ncu == 0).any() == bool(empty)


def test_tri_setup_rejects_a_link_count_unlike_the_poses():
    """The setup kernel reads each face's link pose by index, so its wrapper
    checks the link one-hot against the poses' link count before any launch:
    a mismatch raises there, as the plain version's product raises."""
    from easyhec_torch.geometry import camera
    from easyhec_torch.ops.rebin import tri_setup_cuda
    from easyhec_torch.render.fused import _tri_setup_plain

    F, L = 6, 2
    corners = torch.ones(3, 4, F)
    link = torch.zeros(F, dtype=torch.int64)
    poses = torch.eye(4).repeat(1, L, 1, 1)
    onehot = torch.zeros(L + 1, F)
    onehot[0] = 1.0
    args = (corners, onehot, link, poses, poses, torch.eye(3), 2.0, camera.NEAR_DEFAULT,
            camera.FAR_DEFAULT, True, True)
    with pytest.raises(ValueError, match="3 links|2 links"):
        tri_setup_cuda(*args)
    with pytest.raises(RuntimeError):
        _tri_setup_plain(*args)
