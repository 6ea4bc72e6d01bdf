"""Port parity: the compact fused loss path (easyhec_torch.render.fused and
ops.pose_raster_compact) against easyhec_tpu's, on CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port's side runs the kernels' plain PyTorch versions (CPU tensors).

Tolerances: the bin state is integer work on identical float inputs and
must agree exactly (records included: the same gathers of the same f32
products). The loss sums the same coverage terms in another order (rtol
1e-5); the pose gradient chains the pixel sums through the edge/projection
derivatives, where reordered sums give rtol 1e-4 with an absolute floor of
1e-4 of the largest component.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.geometry import se3 as tse3
from easyhec_torch.ops import pose_raster_compact as tprc
from easyhec_torch.ops.pose_raster import tile_image as t_tile_image
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.render import fused as tf
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.ops import pose_raster_compact as jprc
from easyhec_tpu.ops.pose_raster import tile_image as j_tile_image
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.render import fused as jf
from easyhec_tpu.robot import make_box, make_cylinder
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H = W = 64
BASE = dict(tile_h=16, tile_w=32, capacity=128, binner="count", fused=True,
            compact_chunks=12)
CFGS = {
    "plain": BASE,
    "band_subsort_bigk": dict(BASE, bwd_band_only=True, bin_subsort_rows=True,
                              bin_big_k=64, cull_backfaces=True, margin=2.0),
    # boundary-prefix backward map (compact_tile_acc + dilation)
    "boundary_prefix": dict(BASE, bwd_band_only=True, bwd_chunks=12),
}
XI = np.array([0.02, -0.03, 1.2, 0.05, -0.08, 0.03], np.float32)
K = np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]], np.float32)


def _renderers(cfg):
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    return JR(meshes, H, W, tile=JTC(**cfg)), TR(meshes, H, W, tile=TTC(**cfg), device="cpu")


def _link_poses(B=3):
    rng = np.random.default_rng(0)
    lp = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    lp[1:, 1, :3, 3] += rng.uniform(-0.2, 0.2, (B - 1, 3)).astype(np.float32)
    return lp


def _states(jr, tr, xi, lp, K=K):
    js = jf.build_compact_state(jr, jse3.exp(jnp.asarray(xi)), jnp.asarray(lp), jnp.asarray(K))
    ts = tf.build_compact_state(tr, tse3.exp(torch.from_numpy(xi)), torch.from_numpy(lp),
                                torch.from_numpy(K))
    return js, ts


@pytest.fixture(scope="module")
def scene():
    """The band-only / row-subsorted / span-classed config, 3 frames, with
    both packages' bin states at XI (shared: JAX compiles per shape)."""
    jr, tr = _renderers(CFGS["band_subsort_bigk"])
    lp = _link_poses()
    return (jr, tr, lp) + _states(jr, tr, XI, lp)


@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_build_compact_state_exact(cfg, scene):
    if cfg == "band_subsort_bigk":
        js, ts = scene[3:]
    else:
        jr, tr = _renderers(CFGS[cfg])
        js, ts = _states(jr, tr, XI, _link_poses())
    assert not bool(np.asarray(js.overflow))
    for name in js._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, name)), getattr(ts, name).numpy(), err_msg=name
        )


@pytest.mark.parametrize("budget", ["compact_chunks", "bwd_chunks"])
def test_budget_overflow_flags(budget):
    jr, tr = _renderers(dict(CFGS["boundary_prefix"], **{budget: 1}))
    js, ts = _states(jr, tr, XI, _link_poses())
    assert bool(np.asarray(js.overflow)) and bool(ts.overflow)


def test_boundary_prefix_map_and_gradient_match():
    # zoomed in (f = 400) the arm covers whole tiles, which hold no band
    # pixel: the backward map drops them, equal in both packages, and the
    # loss and pose gradient over the reduced map match JAX's
    jr, tr = _renderers(CFGS["boundary_prefix"])
    lp = _link_poses()
    Kz = np.array([[400.0, 0, 32], [0, 400.0, 32], [0, 0, 1]], np.float32)
    js, ts = _states(jr, tr, XI, lp, Kz)
    for name in js._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, name)), getattr(ts, name).numpy(), err_msg=name)
    assert (ts.bwd_nlive > 0).sum() < (ts.nlive > 0).sum()
    target = (np.random.default_rng(3).random((3, H, W)) > 0.6).astype(np.float32)
    vj, gj, vt, gt = _loss_and_grad_both(jr, tr, XI + 0.002, lp, target, (js, ts), Kz)
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("band_only", [False, True])
def test_pose_tile_loss_compact_matches(band_only, scene):
    js = scene[3]
    rng = np.random.default_rng(1)
    ref = (rng.random((3, H, W)) > 0.6).astype(np.float32)
    cam = np.asarray(jf.cam_rows(jse3.exp(jnp.asarray(XI + 0.01)), jnp.asarray(K), 3))
    ref_t = np.asarray(j_tile_image(jnp.asarray(ref), 16, 32))
    np.testing.assert_array_equal(ref_t, t_tile_image(torch.from_numpy(ref), 16, 32).numpy())
    st = [np.asarray(getattr(js, f)) for f in
          ("rec", "nlive", "ctmap", "ncu", "bwd_nlive", "bwd_ctmap", "bwd_cpos")]
    kw = dict(tile_h=16, tile_w=32, n_tx=2, H=H, W=W, band_only=band_only)
    wts = np.array([0.5, 1.0, 1.5], np.float32)  # a non-uniform cotangent

    def jloss(c):
        return jprc.pose_tile_loss_compact(c, *(jnp.asarray(a) for a in st),
                                           jnp.asarray(ref_t), **kw)

    lj = np.asarray(jloss(jnp.asarray(cam)))
    gj = np.asarray(jax.grad(lambda c: jnp.sum(jloss(c) * wts))(jnp.asarray(cam)))
    c = torch.from_numpy(cam).requires_grad_()
    lt = tprc.pose_tile_loss_compact(c, *(torch.from_numpy(a) for a in st),
                                     torch.from_numpy(ref_t), **kw)
    (lt * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(lt.detach().numpy(), lj, rtol=1e-5)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(c.grad.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def test_compact_tile_acc_and_silhouette_match(scene):
    jr, tr, _, js, ts = scene
    Tj, Tt = jse3.exp(jnp.asarray(XI + 0.005)), tse3.exp(torch.from_numpy(XI + 0.005))
    cam = jf.cam_rows(Tj, jnp.asarray(K), 3)
    acc_j = np.asarray(jprc.compact_tile_acc(
        cam, js.rec, js.nlive, js.ctmap, js.ncu, 8, 16, 32, 2, H, W))
    acc_t = tprc.compact_tile_acc(
        torch.from_numpy(np.asarray(cam)), ts.rec, ts.nlive, ts.ctmap, ts.ncu,
        8, 16, 32, 2, H, W).numpy()
    # The JAX kernel never writes tiles no chunk maps to (undefined memory;
    # its callers mask by counts); the port's wrapper zero-fills them.
    visited = np.broadcast_to((np.asarray(js.counts) > 0)[:, :, None, None], acc_t.shape)
    # acc >= 2 is unspecified (saturation early-out): compare min(acc, 2)
    np.testing.assert_allclose(np.minimum(acc_t, 2)[visited],
                               np.minimum(acc_j, 2)[visited], atol=1e-5)
    np.testing.assert_array_equal(acc_t[~visited], 0.0)
    sj = np.asarray(jf.silhouette_compact(jr, Tj, jnp.asarray(K), js))
    stt = tf.silhouette_compact(tr, Tt, torch.from_numpy(K), ts).numpy()
    np.testing.assert_allclose(stt, sj, atol=1e-5)


def _loss_and_grad_both(jr, tr, xi, lp, target, state_pair=None, K=K):
    js, ts = state_pair if state_pair else (None, None)
    vj, gj = jax.value_and_grad(lambda d: jnp.mean(jf.loss_fused(
        jr, jse3.exp(d), jnp.asarray(lp), jnp.asarray(K),
        masks_ref=jnp.asarray(target), state=js)))(jnp.asarray(xi))
    d = torch.from_numpy(xi).requires_grad_()
    vt = tf.loss_fused(tr, tse3.exp(d), torch.from_numpy(lp), torch.from_numpy(K),
                       masks_ref=torch.from_numpy(target), state=ts).mean()
    vt.backward()
    return float(vj), np.asarray(gj), float(vt), d.grad.numpy()


def test_loss_fused_with_empty_tiles(scene):
    # every pixel masked: tiles no triangle touches contribute Σ ref² with
    # no gradient; both packages add that term the same way
    jr, tr, lp, js, ts = scene
    target = np.ones((3, H, W), np.float32)
    vj, gj, vt, gt = _loss_and_grad_both(jr, tr, XI + 0.01, lp, target, (js, ts))
    assert vj > 100.0
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def test_loss_fused_offscreen_frame(scene):
    # a pose looking away bins nothing: the loss is exactly Σ ref² per frame
    # and the gradient exactly zero, in both packages
    jr, tr, lp = scene[:3]
    xi = np.array([0.0, 0.0, -3.0, 0.0, 0.0, 0.0], np.float32)
    target = np.zeros((3, H, W), np.float32)
    target[:, 2:6, 3:9] = 1.0
    states = _states(jr, tr, xi, lp)
    assert (states[1].ncu == 0).all()
    vj, gj, vt, gt = _loss_and_grad_both(jr, tr, xi, lp, target, states)
    assert vt == vj == float(target[0].sum())
    np.testing.assert_array_equal(gt, 0.0)
    np.testing.assert_array_equal(gj, 0.0)


# ---------------------------------------------------------------------------
# The dense route (compact_chunks == 0): FusedState, K1 loss, K4 silhouette.
# At an uneven 40×56 image the last tile row and column are cropped, so the
# loss crop and the pad pixels of the silhouette's untiling both bite.
# ---------------------------------------------------------------------------

HU, WU = 40, 56
KU = np.array([[60.0, 0, 28], [0, 60.0, 20], [0, 0, 1]], np.float32)
XIU = np.array([0.02, -0.03, 1.0, 0.05, -0.08, 0.03], np.float32)
DENSE = dict(tile_h=16, tile_w=32, capacity=96, binner="count", fused=True, margin=2.0)


@pytest.fixture(scope="module", params=[False, True], ids=["all_px", "band_only"])
def dense_scene(request):
    cfg = dict(DENSE, bwd_band_only=request.param)
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    jr = JR(meshes, HU, WU, tile=JTC(**cfg))
    tr = TR(meshes, HU, WU, tile=TTC(**cfg), device="cpu")
    lp = _link_poses()
    args = (jse3.exp(jnp.asarray(XIU)), jnp.asarray(lp), jnp.asarray(KU))
    js = jf.build_fused_state(jr, *args)
    ts = tr.bin_state(tse3.exp(torch.from_numpy(XIU)), torch.from_numpy(lp),
                      torch.from_numpy(KU))
    return jr, tr, lp, js, ts


def test_build_fused_state_exact(dense_scene):
    js, ts = dense_scene[3:]
    assert isinstance(ts, tf.FusedState) and js._fields == ts._fields
    assert not bool(np.any(np.asarray(js.overflow)))
    for name in js._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, name)), getattr(ts, name).numpy(), err_msg=name)
    # cap 32 overflows this scene's bins, flagged per frame in both
    meshes, lp = dense_scene[1].meshes, dense_scene[2]
    cfg = dict(DENSE, capacity=32)
    jo = jf.build_fused_state(JR(meshes, HU, WU, tile=JTC(**cfg)), jse3.exp(jnp.asarray(XIU)),
                              jnp.asarray(lp), jnp.asarray(KU))
    to = tf.build_fused_state(TR(meshes, HU, WU, tile=TTC(**cfg), device="cpu"),
                              tse3.exp(torch.from_numpy(XIU)), torch.from_numpy(lp),
                              torch.from_numpy(KU))
    assert np.asarray(jo.overflow).any()
    np.testing.assert_array_equal(np.asarray(jo.overflow), to.overflow.numpy())


def test_silhouette_fused_and_vjp_match(dense_scene):
    jr, tr, lp, js, ts = dense_scene
    xi = XIU + 0.01
    g = np.random.default_rng(4).normal(size=(3, HU, WU)).astype(np.float32)
    sj, vjp = jax.vjp(lambda d: jf.silhouette_fused(
        jr, jse3.exp(d), jnp.asarray(lp), jnp.asarray(KU), state=js), jnp.asarray(xi))
    (gj,) = vjp(jnp.asarray(g))
    d = torch.from_numpy(xi).requires_grad_()
    st = tf.silhouette_fused(tr, tse3.exp(d), torch.from_numpy(lp), torch.from_numpy(KU),
                             state=ts)
    assert st.shape == (3, HU, WU)
    st.backward(torch.from_numpy(g))
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), atol=1e-5)
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(d.grad.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    # the renderer entry (state=None rebuilds densely) renders the same image
    with torch.no_grad():
        img = tr.silhouette(tse3.exp(torch.from_numpy(xi)), torch.from_numpy(lp),
                            torch.from_numpy(KU))
    np.testing.assert_allclose(img.numpy(), np.asarray(jr.silhouette(
        jse3.exp(jnp.asarray(xi)), jnp.asarray(lp), jnp.asarray(KU))), atol=1e-5)


def test_dense_loss_fused_matches(dense_scene):
    jr, tr, lp, js, ts = dense_scene
    target = (np.random.default_rng(5).random((3, HU, WU)) > 0.6).astype(np.float32)
    vj, gj, vt, gt = _loss_and_grad_both(jr, tr, XIU + 0.01, lp, target, (js, ts), KU)
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    # state=None builds the dense state itself
    vj2, _, vt2, _ = _loss_and_grad_both(jr, tr, XIU + 0.01, lp, target, None, KU)
    np.testing.assert_allclose(vt2, vj2, rtol=1e-5)


def test_silhouette_fused_refuses_compact_state(scene):
    _, tr, lp, _, ts = scene
    with pytest.raises(TypeError, match="CompactState"):
        tf.silhouette_fused(tr, tse3.exp(torch.from_numpy(XI)), torch.from_numpy(lp),
                            torch.from_numpy(K), state=ts)
    # the renderer drops a compact state and re-bins densely instead
    img = tr.silhouette(tse3.exp(torch.from_numpy(XI)), torch.from_numpy(lp),
                        torch.from_numpy(K), bin_state=ts)
    assert img.shape == (3, H, W) and float(img.max()) == 1.0
