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


@pytest.mark.parametrize(
    "big_k,sub,cap,ry,rx",
    [
        (0, False, 64, 3, 3),  # dense enumeration
        (0, True, 64, 3, 3),  # dense + row-subclassed
        (48, False, 64, 3, 3),  # span-classed
        (48, True, 64, 3, 3),  # span-classed + row-subclassed
        (48, True, 16, 3, 3),  # cap overflow (slots past cap dropped)
        (0, False, 64, 1, 1),  # rect-window overflow
        (8, True, 64, 3, 3),  # big_k budget overflow
    ],
)
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
