"""Port parity: the counted silhouette Function (easyhec_torch.render.binning.
counted_silhouette: the record pack and K5 in one autograd Function, whose
backward writes d(record) through the pack's transpose and gathers at q)
against the two-step composition it replaces (pack_records_counted, then
tile_silhouette) and against easyhec_tpu's counted route (its Pallas K5 in
interpret mode), on CPU.

The scene is the mini arm at an uneven 45×70 image, 16×32 tiles, two
frames, at a bins' cap that is not a multiple of 128 (200: K5 runs it as
256, while q indexes tile*200 + slot) and at one that is (256).

Tolerances: the composition runs the same plain arithmetic in the same
order (1e-6, relative to the largest entry for dfields). Against JAX, the
images sum the same coverage terms in another order (atol 1e-5) and the
field gradients the per-slot pixel sums (rtol 1e-4, absolute floor 1e-4 of
the largest entry), as tests/test_torch_tiled.py holds them.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.ops import tile_raster as ttr
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.render import binning as tb
from easyhec_torch.render import projection as tp
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.ops import tile_raster as jtr
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.render import binning as jb
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W, TH, TW = 45, 70, 16, 32
N_TX = -(-W // TW)
K = np.array([[60.0, 0, 35.0], [0, 60.0, 22.0], [0, 0, 1]], np.float32)
XI = np.array([0.02, -0.02, 1.2, 0.01, -0.01, 0.015], np.float32)


@pytest.fixture(scope="module")
def soa():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    model = parse_urdf(path)
    chain = build_chain(model)
    links = ["base", "upper", "fore"]
    meshes = load_link_meshes(model, link_names=links)
    qs = jnp.linspace(-0.3, 0.3, 2 * chain.n_dof).reshape(2, chain.n_dof)
    lp = jax.vmap(chain.fk)(qs)[:, jnp.asarray([0, 1, 2])]
    jr = JR([meshes[n] for n in links], H, W, tile=JTC(tile_h=TH, tile_w=TW))
    s = jr._triangles_soa(jr.camera_link_poses(jse3.exp(jnp.asarray(XI)), lp),
                          jnp.asarray(K))
    return jax.tree.map(np.asarray, s)


@pytest.mark.parametrize("cap", [200, 256])
def test_counted_silhouette_matches_composition_and_jax(soa, cap):
    cfg = dict(tile_h=TH, tile_w=TW, capacity=cap, binner="count", margin=2.0)
    fj, sj = jb.fields_and_bins(jax.tree.map(jnp.asarray, soa), H, W, JTC(**cfg))
    idx, q, counts = (np.asarray(a) for a in (sj.idx, sj.q, sj.counts))
    assert not bool(np.asarray(sj.overflow).any()) and counts.max() > 0
    g = np.random.default_rng(7).normal(size=(2, idx.shape[1], TH, TW)).astype(np.float32)

    # JAX: the pack, then K5 (interpret mode), and their VJP to the fields
    def jf(f):
        rec = jb.pack_records_counted(f, jnp.asarray(idx), jnp.asarray(q), N_TX, TH, TW, 16)
        return jtr.tile_silhouette(rec, jnp.asarray(counts), TH, TW)

    tiles_j, vjp = jax.vjp(jf, fj)
    (dj,) = vjp(jnp.asarray(g))
    tiles_j, dj = np.asarray(tiles_j), np.asarray(dj)

    bins = [torch.from_numpy(a) for a in (idx, q, counts)]
    f1 = torch.from_numpy(np.array(fj)).requires_grad_()
    launches = (ttr.tile_fwd_cuda.launches, ttr.tile_bwd_cuda.launches,
                ttr.tile_bwd_counted_cuda.launches)
    t1 = tb.counted_silhouette(f1, *bins, N_TX, TH, TW)
    t1.backward(torch.from_numpy(g))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (ttr.tile_fwd_cuda.launches, ttr.tile_bwd_cuda.launches,
            ttr.tile_bwd_counted_cuda.launches) == launches

    f2 = torch.from_numpy(np.array(fj)).requires_grad_()
    rec = tb.pack_records_counted(f2, bins[0], bins[1], N_TX, TH, TW, 16)
    t2 = ttr.tile_silhouette(rec, bins[2], TH, TW)
    t2.backward(torch.from_numpy(g))

    scale = float(np.abs(dj).max())
    assert scale > 0 and 0 < tiles_j.mean() < 1
    np.testing.assert_allclose(t1.detach().numpy(), t2.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(f1.grad.numpy(), f2.grad.numpy(), rtol=0, atol=1e-6 * scale)
    for t, f in ((t1, f1), (t2, f2)):
        np.testing.assert_allclose(t.detach().numpy(), tiles_j, atol=1e-5)
        np.testing.assert_allclose(f.grad.numpy(), dj, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("cap", [200, 256])
def test_counted_plain_writes_the_pack_transpose(soa, cap):
    """The plain counted K5b: at the positions q names, dg is the pack's
    transpose of the dense dtri, indexed by the bins' cap; its last column
    is zero."""
    cfg = TTC(tile_h=TH, tile_w=TW, capacity=cap, binner="count", margin=2.0)
    t = tp.TrianglesSoA(*(torch.from_numpy(np.array(a)) for a in soa))
    fields, st = tb.fields_and_bins(t, H, W, cfg)
    rec = ttr.pad_cap(tb.pack_records_counted(fields, st.idx, st.q, N_TX, TH, TW, 16))
    assert rec.shape[-1] == 256
    meta = ttr.TileMeta(TH, TW, 1.0)
    _, acc = ttr.tile_fwd_plain(rec, st.counts, meta)
    g = torch.from_numpy(np.random.default_rng(8).normal(size=acc.shape).astype(np.float32))
    dg = ttr.tile_bwd_counted_plain(rec, st.counts, acc, g, meta, N_TX, cap)
    Kt = st.counts.shape[1]
    assert dg.shape == (2, 13, Kt * cap + 1) and (dg[:, :, -1] == 0).all()
    dtri = ttr.tile_bwd_plain(rec, st.counts, acc, g, meta)
    x0 = (torch.arange(Kt) % N_TX).float() * TW
    y0 = (torch.arange(Kt) // N_TX).float() * TH
    for b in range(2):
        for k in range(Kt):
            n = int(st.counts[b, k])
            d = dtri[b, k, :13, :n]
            got = dg[b, :, k * cap:k * cap + n]
            want = d.clone()
            for e in range(3):
                want[3 * e] = d[3 * e] + d[3 * e + 2] * x0[k]
                want[3 * e + 1] = d[3 * e + 1] + d[3 * e + 2] * y0[k]
            torch.testing.assert_close(got, want, rtol=0, atol=0)
