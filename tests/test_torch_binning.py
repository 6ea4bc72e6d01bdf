"""Port parity: easyhec_torch.render.binning.bin_count against the JAX
counting-sort binner, EXACT on idx, counts, q and overflow.

Both packages get the same numpy bboxes, so exactness does not hang on the
projection's float rounding (a bbox within an ulp of a tile edge would
otherwise bin differently). The JAX ranks come from a float32 counting
sort; the port's from a stable torch.sort — equal by construction.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.render import binning as tb
from easyhec_torch.render.tiled import _topk_compact as t_topk
from easyhec_tpu.render import binning as jb
from easyhec_tpu.render.tiled import _topk_compact as j_topk
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W, TH, TW = 64, 96, 16, 32


def _boxes(seed, B=2, F=300, big_frac=0.1):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-10, W + 10, (B, F))
    cy = rng.uniform(-10, H + 10, (B, F))
    hw = rng.uniform(0.2, 6.0, (B, F))
    hh = rng.uniform(0.2, 6.0, (B, F))
    big = rng.random((B, F)) < big_frac
    hw = np.where(big, rng.uniform(10, 40, (B, F)), hw)
    hh = np.where(big, rng.uniform(10, 30, (B, F)), hh)
    # a few bboxes exactly on tile edges
    cx[:, :5] = TW * np.arange(1, 6)[None] % W
    lox, hix = cx - hw, cx + hw
    loy, hiy = cy - hh, cy + hh
    valid = rng.random((B, F)) < 0.9
    suby = 0.5 * (loy + hiy)
    return [a.astype(np.float32) for a in (lox, loy, hix, hiy)] + [
        valid, suby.astype(np.float32)
    ]


def _run_both(arrs, sub, **kw):
    lox, loy, hix, hiy, valid, suby = arrs
    js = jb.bin_count(
        *(jnp.asarray(a) for a in (lox, loy, hix, hiy, valid)),
        jnp.asarray(suby) if sub else None, **kw,
    )
    ts = tb.bin_count(
        *(torch.from_numpy(a) for a in (lox, loy, hix, hiy, valid)),
        torch.from_numpy(suby) if sub else None, **kw,
    )
    return js, ts


def _assert_equal(js, ts):
    for name in ("idx", "counts", "q", "overflow"):
        np.testing.assert_array_equal(
            np.asarray(getattr(js, name)), getattr(ts, name).numpy(), err_msg=name
        )


EXACT_CASES = [
    (0, False, 64, 3, 3),  # dense enumeration
    (0, True, 64, 3, 3),  # dense + row-subclassed
    (48, False, 64, 3, 3),  # span-classed
    (48, True, 64, 3, 3),  # span-classed + row-subclassed
    (48, True, 16, 3, 3),  # cap overflow (slots past cap dropped)
    (0, False, 64, 1, 1),  # rect-window overflow
    (8, True, 64, 3, 3),  # big_k budget overflow
]


@pytest.mark.parametrize("big_k,sub,cap,ry,rx", EXACT_CASES)
def test_bin_count_exact(big_k, sub, cap, ry, rx):
    js, ts = _run_both(
        _boxes(big_k + cap + ry), sub, H=H, W=W, tile_h=TH, tile_w=TW,
        cap=cap, ry=ry, rx=rx, big_k=big_k,
    )
    _assert_equal(js, ts)


def test_overflow_sources_fire():
    arrs = _boxes(7)
    # ry, rx = the whole 4 x 3 tile grid: no rect can exceed the window
    kw = dict(H=H, W=W, tile_h=TH, tile_w=TW, ry=4, rx=3)
    _, ok = _run_both(arrs, True, cap=256, big_k=64, **kw)
    _, capov = _run_both(arrs, True, cap=8, big_k=64, **kw)
    _, rectov = _run_both(arrs, False, cap=256, big_k=0, **{**kw, "ry": 1, "rx": 1})
    assert not ok.overflow.any()
    assert capov.overflow.all()
    assert rectov.overflow.all()


def test_topk_compact_exact():
    rng = np.random.default_rng(3)
    ov = rng.random((4, 50)) < 0.3
    for k in (3, 20):
        ji, jc, jo = j_topk(jnp.asarray(ov), k, 50)
        ti, tc, to = t_topk(torch.from_numpy(ov), k, 50)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        assert bool(jo) == bool(to)


def _slot_rule(lox, loy, hix, hiy, valid, suby, H, W, tile_h, tile_w, cap, ry, rx, big_k):
    """The binner's contract written out entry by entry (numpy, one frame at
    a time), as the card's counting-sort kernels (ops/csrc/binning.cu)
    implement it: within a tile, an entry's slot is the tile's class-0 total
    if its class is 1, plus its rank among the tile's entries of its class,
    ordered by group (rows of a <= 2 x 1 rect first, then big_k window
    entries), then by triangle; a need_big triangle ranked big_k or later
    among them has no entry; slots at or past cap are dropped."""
    B, F = valid.shape
    f32 = np.float32
    n_ty, n_tx = -(-H // tile_h), -(-W // tile_w)
    K = n_ty * n_tx
    by = min(2, ry)
    R = by + ry * rx if big_k > 0 else ry * rx
    idx = np.full((B, K, cap), F, np.int32)
    counts = np.zeros((B, K), np.int32)
    q = np.full((B, F, R), K * cap, np.int32)
    overflow = np.zeros(B, bool)

    def tile_of(v, t, n):
        return int(np.clip(np.floor(f32(v) / f32(t)), 0, n - 1))

    for b in range(B):
        lists = {}  # (tile, class, group) -> [(triangle, q column)] in triangle order
        n_big = 0
        for f in range(F):
            if not (valid[b, f] and hix[b, f] > 0 and lox[b, f] < W and hiy[b, f] > 0
                    and loy[b, f] < H):
                continue
            ty0, tx0 = tile_of(loy[b, f], tile_h, n_ty), tile_of(lox[b, f], tile_w, n_tx)
            sy = tile_of(hiy[b, f], tile_h, n_ty) - ty0 + 1
            sx = tile_of(hix[b, f], tile_w, n_tx) - tx0 + 1
            overflow[b] |= sy > ry or sx > rx
            if big_k <= 0:
                group, rows, cols = 0, range(min(sy, ry)), range(min(sx, rx))
            elif sy > by or sx > 1:
                n_big += 1
                if n_big > min(big_k, F):
                    continue
                group, rows, cols = 1, range(min(sy, ry)), range(min(sx, rx))
            else:
                group, rows, cols = 0, range(min(sy, by)), range(1)
            for iy in rows:
                for ix in cols:
                    ty = ty0 + iy
                    cls = 0
                    if suby is not None:
                        cls = int((f32(suby[b, f]) - f32(ty) * f32(tile_h)) * f32(2)
                                  >= f32(tile_h))
                    col = (by + iy * rx + ix if group else iy) if big_k > 0 else iy * rx + ix
                    lists.setdefault((ty * n_tx + tx0 + ix, cls, group), []).append((f, col))
        overflow[b] |= big_k > 0 and n_big > min(big_k, F)
        for t in range(K):
            ordered = [e for c in (0, 1) for g in (0, 1) for e in lists.get((t, c, g), [])]
            counts[b, t] = min(len(ordered), cap)
            overflow[b] |= len(ordered) > cap
            for slot, (f, col) in enumerate(ordered[:cap]):
                idx[b, t, slot] = f
                q[b, f, col] = t * cap + slot
    return idx, counts, q, overflow


@pytest.mark.parametrize("big_k,sub,cap,ry,rx", EXACT_CASES)
def test_bin_count_slot_rule(big_k, sub, cap, ry, rx):
    """The plain version (the CPU route of bin_count) against the slot rule
    that the card's kernels implement, on test_bin_count_exact's cases."""
    lox, loy, hix, hiy, valid, suby = _boxes(big_k + cap + ry)
    kw = dict(H=H, W=W, tile_h=TH, tile_w=TW, cap=cap, ry=ry, rx=rx, big_k=big_k)
    ts = tb.bin_count(*(torch.from_numpy(a) for a in (lox, loy, hix, hiy, valid)),
                      torch.from_numpy(suby) if sub else None, **kw)
    want = _slot_rule(lox, loy, hix, hiy, valid, suby if sub else None, **kw)
    for name, w in zip(("idx", "counts", "q", "overflow"), want):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), w, err_msg=name)
    assert want[0].shape[-1] == cap and (want[1] > 0).any()
