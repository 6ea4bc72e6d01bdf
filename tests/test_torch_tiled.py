"""Port parity: the unfused tiled route of easyhec_torch (edge fields, the
counting binner's fields_and_bins, the gather-only record pack, the counted
and top-k silhouettes through K5, RobotRenderer(tile.fused=False), per-link
silhouettes and the tiled depth pass) against easyhec_tpu, on CPU.

The scene is the mini arm at an uneven 45×70 image (16×32 tiles: the crop
bites in both directions), two frames. JAX's K5 runs in interpret mode, the
port's its plain versions.

Tolerances: bboxes, bins and the record pack's forward agree exactly given
the same triangles; the normalized edge functions to one ulp (XLA fuses
their arithmetic). Images sum
the same coverage terms in another order (atol 1e-5). The record pack's
backward sums up to R entries per triangle (rtol 1e-6). Pose gradients chain
the per-slot pixel sums through the edge setup (rtol 1e-4, absolute floor
1e-4 of the largest component). Depth agrees to 1e-5 relative; a pixel's
triangle id may differ where two triangles reach it at depths equal to
rounding, so its share is bounded (1 %) and the link id must agree there.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.geometry import se3 as tse3
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.render import binning as tb
from easyhec_torch.render import projection as tp
from easyhec_torch.render import raster_core as trc
from easyhec_torch.render import tiled as tt
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.render import binning as jb
from easyhec_tpu.render import raster_core as jrc
from easyhec_tpu.render import tiled as jt
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 45, 70
K = np.array([[60.0, 0, 35.0], [0, 60.0, 22.0], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]
CFG = dict(tile_h=16, tile_w=32, capacity=256, binner="count", margin=2.0)
XI = np.array([0.02, -0.02, 1.2, 0.01, -0.01, 0.015], np.float32)


@pytest.fixture(scope="module")
def rig():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    model = parse_urdf(path)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    mesh_list = [meshes[n] for n in LINKS]
    qs = jnp.linspace(-0.3, 0.3, 2 * chain.n_dof).reshape(2, chain.n_dof)
    lp = np.asarray(jax.vmap(chain.fk)(qs)[:, jnp.asarray([0, 1, 2])])
    jr = JR(mesh_list, H, W, tile=JTC(**CFG))
    tr = TR(mesh_list, H, W, tile=TTC(**CFG), device="cpu")
    Tc = jse3.exp(jnp.asarray(XI))
    soa = jr._triangles_soa(jr.camera_link_poses(Tc, jnp.asarray(lp)), jnp.asarray(K))
    soa = jax.tree.map(np.asarray, soa)
    return mesh_list, lp, jr, tr, soa


def _t(soa):
    return tp.TrianglesSoA(*(torch.from_numpy(np.array(a)) for a in soa))


def test_edge_fields_and_bins_exact(rig):
    *_, soa = rig
    fj = [np.asarray(f) for f in jt._edge_fields_soa(jax.tree.map(jnp.asarray, soa))]
    ft = [f.numpy() for f in tt._edge_fields_soa(_t(soa))]
    for i, (a, b) in enumerate(zip(ft, fj)):
        if i >= 9:  # bboxes: min/max, exact
            np.testing.assert_array_equal(a, b)
        else:  # XLA fuses the edge normalization: one ulp
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for cfg in (CFG, dict(CFG, rect_y=2, rect_x=2, bin_big_k=64, capacity=96)):
        fj, sj = jb.fields_and_bins(jax.tree.map(jnp.asarray, soa), H, W, JTC(**cfg))
        ftt, st = tb.fields_and_bins(_t(soa), H, W, TTC(**cfg))
        np.testing.assert_allclose(ftt.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-6)
        for name in ("idx", "counts", "q", "overflow"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(sj, name)), err_msg=name)
    assert bool(np.asarray(sj.overflow).any())  # cap 96: some bins overflow


def test_edge_field_ties_split_like_jax():
    """min/max ties (shared vertex coordinates) split the gradient the same
    way in both packages."""
    u = np.array([[[1.0, 4.0]], [[5.0, 4.0]], [[1.0, 6.0]]], np.float32)[:, 0]  # [3, F=2]
    v = np.array([[2.0, 2.0], [2.0, 7.0], [6.0, 7.0]], np.float32)
    w = np.random.default_rng(0).normal(size=(13, 2)).astype(np.float32)

    def jf(u, v):
        t = jt.TrianglesSoA(u=u, v=v, z=jnp.ones((3, 2)), valid=jnp.ones(2, bool))
        return sum(jnp.sum(f * w[i]) for i, f in enumerate(jt._edge_fields_soa(t)))

    gju, gjv = jax.grad(jf, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    tu = torch.from_numpy(u).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    t = tp.TrianglesSoA(u=tu, v=tv, z=torch.ones(3, 2), valid=torch.ones(2, dtype=torch.bool))
    sum((f * torch.from_numpy(w[i])).sum() for i, f in enumerate(tt._edge_fields_soa(t))).backward()
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gju), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gjv), rtol=1e-6, atol=1e-6)


def test_pack_records_counted_both_ways(rig):
    *_, soa = rig
    fj, sj = jb.fields_and_bins(jax.tree.map(jnp.asarray, soa), H, W, JTC(**CFG))
    n_tx = -(-W // 32)
    args = (np.asarray(sj.idx), np.asarray(sj.q))
    rj, vjp = jax.vjp(lambda f: jb.pack_records_counted(
        f, jnp.asarray(args[0]), jnp.asarray(args[1]), n_tx, 16, 32, 16), fj)
    d = np.random.default_rng(1).normal(size=rj.shape).astype(np.float32)
    (dj,) = vjp(jnp.asarray(d))
    f = torch.from_numpy(np.asarray(fj)).requires_grad_()
    rt = tb.pack_records_counted(f, torch.from_numpy(args[0]), torch.from_numpy(args[1]),
                                 n_tx, 16, 32, 16)
    np.testing.assert_array_equal(rt.detach().numpy(), np.asarray(rj))
    rt.backward(torch.from_numpy(d))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(dj)).max())


@pytest.mark.parametrize("binner", ["count", "topk"])
def test_silhouette_tiled_routes(rig, binner):
    *_, soa = rig
    cfg = dict(CFG, binner=binner)
    g = np.random.default_rng(2).normal(size=(2, H, W)).astype(np.float32)

    def jsil(u, v):
        t = soa._replace(u=u, v=v)
        return jt.silhouette_tiled(jax.tree.map(jnp.asarray, t), H, W, JTC(**cfg),
                                   return_overflow=True)

    (sj, ovj), vjp = jax.vjp(lambda u, v: jsil(u, v), jnp.asarray(soa.u), jnp.asarray(soa.v))
    guj, gvj = vjp((jnp.asarray(g), jnp.zeros((), bool)))
    t = _t(soa)
    u, v = t.u.requires_grad_(), t.v.requires_grad_()
    st, ovt = tt.silhouette_tiled(t._replace(u=u, v=v), H, W, TTC(**cfg), return_overflow=True)
    st.backward(torch.from_numpy(g))
    assert bool(ovt) == bool(ovj) is False
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), atol=1e-5)
    assert 0.01 < float(np.asarray(sj).mean()) < 0.9
    for a, b in ((u.grad, guj), (v.grad, gvj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    # the AoS input goes the same way
    aos = tp.to_aos(_t(soa))
    np.testing.assert_array_equal(tt.silhouette_tiled(aos, H, W, TTC(**cfg)).numpy(),
                                  st.detach().numpy())


def test_renderer_unfused_silhouette_pose_gradient(rig):
    _, lp, jr, tr, _ = rig
    g = np.random.default_rng(3).normal(size=(2, H, W)).astype(np.float32)
    sj, vjp = jax.vjp(lambda d: jr.silhouette(jse3.exp(d), jnp.asarray(lp), jnp.asarray(K)),
                      jnp.asarray(XI))
    (gj,) = vjp(jnp.asarray(g))
    d = torch.from_numpy(XI).requires_grad_()
    st = tr.silhouette(tse3.exp(d), torch.from_numpy(lp), torch.from_numpy(K))
    st.backward(torch.from_numpy(g))
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), atol=1e-5)
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(d.grad.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    # a reused bin state gives the same image
    args = (tse3.exp(torch.from_numpy(XI)), torch.from_numpy(lp), torch.from_numpy(K))
    state = tr.bin_state(*args)
    assert isinstance(state, tb.BinState) and not state.idx.requires_grad
    np.testing.assert_array_equal(tr.silhouette(*args, bin_state=state).detach().numpy(),
                                  st.detach().numpy())


def test_link_silhouettes(rig):
    _, lp, jr, tr, _ = rig
    lj = jr.link_silhouettes(jse3.exp(jnp.asarray(XI)), jnp.asarray(lp), jnp.asarray(K))
    lt = tr.link_silhouettes(tse3.exp(torch.from_numpy(XI)), torch.from_numpy(lp),
                             torch.from_numpy(K))
    assert lt.shape == (2, 3, H, W)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)


def test_depth_and_link_ids(rig):
    _, lp, jr, tr, _ = rig
    zj, idj = (np.asarray(a) for a in jr.depth(jse3.exp(jnp.asarray(XI)), jnp.asarray(lp),
                                               jnp.asarray(K)))
    zt, idt = (a.numpy() for a in tr.depth(tse3.exp(torch.from_numpy(XI)),
                                            torch.from_numpy(lp), torch.from_numpy(K)))
    assert (idj >= 0).mean() > 0.01 and set(np.unique(idj)) <= {-1, 0, 1, 2}
    np.testing.assert_allclose(zt, zj, rtol=1e-5)
    assert (idt != idj).mean() <= 0.01


def test_raster_core_and_projection_match(rig):
    mesh_list, lp, jr, tr, _ = rig
    Tc = np.asarray(jse3.exp(jnp.asarray(XI)))
    Tcl = np.asarray(jr.camera_link_poses(jnp.asarray(Tc), jnp.asarray(lp)))
    vj = np.asarray(jr._triangles(jnp.asarray(Tcl), jnp.asarray(K)).uv)
    vt = tr._triangles(torch.from_numpy(Tcl), torch.from_numpy(K)).uv.numpy()
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-4)
    tri = jr._triangles(jnp.asarray(Tcl[0]), jnp.asarray(K))
    ej = jrc.build_edges(tri.uv, tri.z, tri.valid)
    et = trc.build_edges(*(torch.from_numpy(np.asarray(a)) for a in tri))
    for name in ("abc", "zinv", "bary_abc", "bbox", "valid"):
        np.testing.assert_allclose(getattr(et, name).numpy(), np.asarray(getattr(ej, name)),
                                   rtol=1e-6, atol=1e-5, err_msg=name)
    pix_j = jrc.pixel_grid(8, 12, 3, 5)
    pix_t = trc.pixel_grid(8, 12, 3, 5)
    np.testing.assert_array_equal(pix_t.numpy(), np.asarray(pix_j))
    np.testing.assert_allclose(trc.bbox_distance(pix_t, et.bbox).numpy(),
                               np.asarray(jrc.bbox_distance(pix_j, ej.bbox)), atol=1e-5)
    pj = jrc.pixel_grid(H, W)
    zj, idj = jrc.depth_from_edges(pj, ej)
    zt, idt = trc.depth_from_edges(trc.pixel_grid(H, W), et)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5)
    assert (idt.numpy() != np.asarray(idj)).mean() <= 0.01
