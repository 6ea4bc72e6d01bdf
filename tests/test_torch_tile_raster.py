"""Port parity: the unfused tile rasterizer (easyhec_torch.ops.tile_raster,
K5 forward and backward) against easyhec_tpu's tile_silhouette, on CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port's side runs the kernels' plain PyTorch versions (CPU tensors). The
records are tile-local edge records of random triangles (JAX's own
_edge_fields_soa), 3 frames × 4 tiles, with counts of 0, partial and full,
at caps 128 and 64 (padded to a chunk multiple by the port), a 32×48 tile
(1536 pixels, above one block of threads on the card), sharpness 1 and 2.5,
and a dense stack of tile-covering triangles that saturates a tile (the
kernels' early exit).

Tolerances: the forward sums the same coverage terms in another order (atol
1e-5 on clip(acc) and on min(acc, 2), where acc above 2 is unspecified); the
backward's per-slot pixel sums likewise (rtol 1e-4, absolute floor 1e-4 of
the largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.ops import tile_raster as ttr
from easyhec_tpu.ops import tile_raster as jtr
from easyhec_tpu.render.projection import TrianglesSoA
from easyhec_tpu.render.tiled import _edge_fields_soa
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

B, T = 3, 4


def _records(cap, th, tw, seed=0, stack=False):
    """(tri [B, T, 16, cap], counts [B, T]) numpy: random tile-local
    triangles around the tile. With stack, tile (0, 0) holds `cap` large
    triangles that each cover the whole tile (acc ~ cap everywhere)."""
    rng = np.random.default_rng(seed)
    n = B * T * cap
    c = rng.uniform([-4.0, -4.0], [tw + 4.0, th + 4.0], (n, 2)).astype(np.float32)
    off = rng.uniform(-0.6, 0.6, (n, 3, 2)) * np.array([tw, th]) * rng.uniform(0.1, 1.0, (n, 1, 1))
    uv = (c[:, None, :] + off).astype(np.float32)  # [n, 3, 2]
    if stack:
        big = np.array([[-3 * tw, -th], [4 * tw, -th], [tw / 2, 6 * th]], np.float32)
        jit = rng.normal(0, 0.3, (cap, 3, 2)).astype(np.float32)
        uv = uv.reshape(B, T, cap, 3, 2)
        uv[0, 0] = big + jit
        uv = uv.reshape(n, 3, 2)
    soa = TrianglesSoA(u=jnp.asarray(uv[..., 0].T), v=jnp.asarray(uv[..., 1].T),
                       z=jnp.ones((3, n)), valid=jnp.ones(n, bool))
    fl = np.stack([np.asarray(f) for f in _edge_fields_soa(soa)])  # [13, n]
    rec = np.zeros((16, n), np.float32)
    rec[:13] = fl
    tri = rec.reshape(16, B, T, cap).transpose(1, 2, 0, 3).copy()
    counts = np.array([[0, cap // 3 + 1, cap, 5], [cap, 1, 0, cap - 7],
                       [cap // 2, cap, cap, 0]], np.int32)
    if stack:
        counts[0, 0] = cap
    return tri, counts


CASES = [  # (cap, th, tw, sharpness, stack)
    (128, 8, 16, 1.0, False),
    (64, 8, 16, 1.0, False),
    (128, 32, 48, 1.0, False),
    (64, 8, 32, 2.5, False),
    (256, 8, 16, 1.0, True),
]


@pytest.mark.parametrize("cap,th,tw,sharp,stack", CASES,
                         ids=["cap128", "cap64", "tile32x48", "sharp2.5", "stack"])
def test_tile_silhouette_matches(cap, th, tw, sharp, stack):
    tri, counts = _records(cap, th, tw, stack=stack)
    g = np.random.default_rng(1).normal(size=(B, T, th, tw)).astype(np.float32)
    sj, vjp = jax.vjp(lambda t: jtr.tile_silhouette(t, jnp.asarray(counts), th, tw, sharp),
                      jnp.asarray(tri))
    (dj,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(tri).requires_grad_()
    launches = ttr.tile_fwd_cuda.launches, ttr.tile_bwd_cuda.launches
    st = ttr.tile_silhouette(t, torch.from_numpy(counts), th, tw, sharp)
    st.backward(torch.from_numpy(g))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (ttr.tile_fwd_cuda.launches, ttr.tile_bwd_cuda.launches) == launches
    sj, dj = np.asarray(sj), np.asarray(dj)
    np.testing.assert_allclose(st.detach().numpy(), sj, atol=1e-5)
    assert 0 < sj.mean() < 1
    dt = t.grad.numpy()
    assert dt.shape == tri.shape and np.abs(dj).max() > 0
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4 * np.abs(dj).max())
    # defined everywhere: zero beyond each tile's count and in rows 13-15
    slot = np.arange(cap)
    assert (dt[..., 13:, :] == 0).all()
    assert (dt.transpose(0, 1, 3, 2)[slot[None, None, :] >= counts[..., None]] == 0).all()
    if stack:  # the saturated tile: clip(acc) = 1, no gradient
        assert (st.detach().numpy()[0, 0] == 1).all() and (dt[0, 0] == 0).all()


@pytest.mark.parametrize("stack", [False, True])
def test_plain_acc_matches_interpret(stack):
    """The raw coverage acc (below 2, where it is specified) of the plain
    forward against the Pallas forward's residual in interpret mode."""
    cap, th, tw = (256, 8, 16) if stack else (128, 8, 16)
    tri, counts = _records(cap, th, tw, seed=2, stack=stack)
    fwd = jtr._make_tile_silhouette(th, tw, cap, 1.0).fwd  # the custom-VJP forward
    _, (_, _, acc_j) = fwd(jnp.asarray(tri), jnp.asarray(counts))
    meta = ttr.TileMeta(th, tw, 1.0)
    out_p, acc_p = ttr.tile_fwd_plain(torch.from_numpy(tri), torch.from_numpy(counts), meta)
    np.testing.assert_allclose(np.minimum(acc_p.numpy(), 2), np.minimum(np.asarray(acc_j), 2),
                               atol=1e-5)
    np.testing.assert_array_equal(out_p.numpy(), np.clip(acc_p.numpy(), 0, 1))
    assert (acc_p.numpy()[counts == 0] == 0).all()
    if stack:
        assert acc_p.numpy()[0, 0].min() >= 2  # saturated: the early exit fires
