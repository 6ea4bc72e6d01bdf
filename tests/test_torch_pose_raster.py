"""Port parity: the dense fused pose-raster kernels (easyhec_torch.ops.pose_raster,
K1 loss and K4 silhouette, forward and backward) against easyhec_tpu's
pose_tile_loss / pose_tile_silhouette, on CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port's side runs the kernels' plain PyTorch versions (CPU tensors). The
records and counts come from JAX's build_fused_state on a two-link scene at
an uneven 40×56 image (tiles of 16×32: the crop bites in both directions),
at cap 128 and at cap 96 (padded to a chunk multiple by both packages).

Tolerances: the forward sums the same coverage terms in another order
(rtol 1e-5 on the loss, atol 1e-5 on the image); the pose gradient chains
the pixel sums through the edge/projection derivatives, where reordered sums
give rtol 1e-4 with an absolute floor of 1e-4 of the largest component.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.ops import pose_raster as tpr
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.ops import pose_raster as jpr
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.render import fused as jf
from easyhec_tpu.robot import make_box, make_cylinder

H, W = 40, 56
TH, TW, N_TX = 16, 32, 2
XI = np.array([0.02, -0.03, 1.0, 0.05, -0.08, 0.03], np.float32)
K = np.array([[60.0, 0, 28], [0, 60.0, 20], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module", params=[128, 96], ids=["cap128", "cap96"])
def records(request):
    """(cam, rec, counts) numpy arrays of a 3-frame scene, cam at a pose
    0.01 off the binning pose (inside the margin)."""
    cap = request.param
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    jr = JR(meshes, H, W, tile=JTC(TH, TW, cap, binner="count", fused=True,
                                   margin=2.0))
    lp = np.tile(np.eye(4, dtype=np.float32), (3, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    lp[1:, 1, :3, 3] += np.random.default_rng(0).uniform(-0.2, 0.2, (2, 3))
    st = jf.build_fused_state(jr, jse3.exp(jnp.asarray(XI)), jnp.asarray(lp),
                              jnp.asarray(K))
    assert not bool(np.any(np.asarray(st.overflow)))
    counts = np.asarray(st.counts)
    assert counts.max() > 0 and (counts == 0).any()  # visited and empty tiles
    cam = np.asarray(jf.cam_rows(jse3.exp(jnp.asarray(XI + 0.01)), jnp.asarray(K), 3))
    return cam, np.asarray(st.rec), counts


def _ref_tiles(seed=1):
    ref = (np.random.default_rng(seed).random((3, H, W)) > 0.6).astype(np.float32)
    return np.asarray(jpr.tile_image(jnp.asarray(ref), TH, TW))


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("band_only", [False, True])
def test_pose_tile_loss_matches(records, band_only):
    cam, rec, counts = records
    ref_t = _ref_tiles()
    kw = dict(tile_h=TH, tile_w=TW, n_tx=N_TX, H=H, W=W, band_only=band_only)
    wts = np.array([0.5, 1.0, 1.5], np.float32)  # a non-uniform cotangent

    def jloss(c):
        return jpr.pose_tile_loss(c, jnp.asarray(rec), jnp.asarray(counts),
                                  jnp.asarray(ref_t), **kw)

    lj = np.asarray(jloss(jnp.asarray(cam)))
    gj = np.asarray(jax.grad(lambda c: jnp.sum(jloss(c) * wts))(jnp.asarray(cam)))
    c, r, n, ref = _t(cam, rec, counts, ref_t)
    c.requires_grad_()
    launches = tpr.loss_fwd_cuda.launches, tpr.loss_bwd_cuda.launches
    lt = tpr.pose_tile_loss(c, r, n, ref, **kw)
    (lt * torch.from_numpy(wts)).sum().backward()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tpr.loss_fwd_cuda.launches, tpr.loss_bwd_cuda.launches) == launches
    np.testing.assert_allclose(lt.detach().numpy(), lj, rtol=1e-5)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(c.grad.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("band_only", [False, True])
def test_pose_tile_silhouette_matches(records, band_only):
    cam, rec, counts = records
    kw = dict(tile_h=TH, tile_w=TW, n_tx=N_TX, band_only=band_only)
    g = np.random.default_rng(2).normal(size=(3, counts.shape[1], TH, TW)).astype(np.float32)
    sj, vjp = jax.vjp(lambda c: jpr.pose_tile_silhouette(
        c, jnp.asarray(rec), jnp.asarray(counts), **kw), jnp.asarray(cam))
    (gj,) = vjp(jnp.asarray(g))
    c, r, n = _t(cam, rec, counts)
    c.requires_grad_()
    st = tpr.pose_tile_silhouette(c, r, n, **kw)
    st.backward(torch.from_numpy(g))
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), atol=1e-5)
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0
    assert (gj[:, 12:] == 0).all() and (c.grad.numpy()[:, 12:] == 0).all()
    np.testing.assert_allclose(c.grad.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def test_plain_kernels_directly(records):
    """The four plain versions against each other's contracts: K1f's loss is
    K4f's image against the reference over the crop; acc is the unclipped
    coverage; unvisited tiles render 0 and lose Σ ref² over the crop."""
    cam, rec, counts = records
    ref_t = _ref_tiles(3)
    c, r, n, ref = _t(cam, rec, counts, ref_t)
    r = tpr._pad_records(r, n)
    n = n.to(torch.int32)
    meta = tpr.Meta(TH, TW, N_TX, H, W)
    loss, acc = tpr.loss_fwd_plain(c, r, n, ref, meta)
    sil, acc2 = tpr.sil_fwd_plain(c, r, n, meta)
    torch.testing.assert_close(acc, acc2, rtol=0, atol=0)
    torch.testing.assert_close(sil, acc.clamp(0, 1), rtol=0, atol=0)
    T = counts.shape[1]
    crop = tpr.crop_mask(torch.arange(T), N_TX, TH, TW, H, W).reshape(T, TH, TW)
    assert crop.sum() == H * W and crop.numel() > H * W  # the crop bites
    e = (sil - ref) * crop
    torch.testing.assert_close(loss, (e * e).sum((-2, -1)), rtol=1e-6, atol=1e-6)
    empty = torch.from_numpy(counts == 0)
    assert (acc[empty] == 0).all()
    torch.testing.assert_close(loss[empty], ((ref * crop) ** 2).sum((-2, -1))[empty])
    # both backwards are zero on tiles with no records
    gb = torch.ones(3)
    parts = tpr.loss_bwd_plain(c, r, n, ref, acc, gb, meta)
    assert (parts[empty] == 0).all() and parts.abs().max() > 0
    parts = tpr.sil_bwd_plain(c, r, n, acc, torch.ones_like(acc), meta)
    assert (parts[empty] == 0).all()


def test_bad_record_axis_raises(records):
    cam, rec, counts = records
    bad = rec[..., :-1]
    with pytest.raises(ValueError, match="multiple of"):
        jpr.pose_tile_loss(jnp.asarray(cam), jnp.asarray(bad), jnp.asarray(counts),
                           jnp.asarray(_ref_tiles()), TH, TW, N_TX, H, W)
    c, r, n, ref = _t(cam, bad, counts, _ref_tiles())
    with pytest.raises(ValueError, match="multiple of"):
        tpr.pose_tile_loss(c, r, n, ref, TH, TW, N_TX, H, W)
    with pytest.raises(ValueError, match="multiple of"):
        tpr.pose_tile_silhouette(c, r, n, TH, TW, N_TX)


@pytest.mark.parametrize("sharpness", [1.0, 2.0])
def test_band_mask_holds_every_nonzero_pair(records, sharpness):
    """The forward kernels evaluate a lane only at the pixel centres in its
    bbox dilated by the soft band 0.5/sharpness (band_mask): every pair with
    nonzero coverage lies there, so each pair they skip adds an exact zero.
    (Sharpness 1 and 2 keep the band and its products exact in f32.)"""
    cam, rec, counts = records
    c, r, n = _t(cam, rec, counts)
    r = tpr._pad_records(r, n)
    cap = r.shape[-1] // n.shape[1]
    px, py = tpr.pix_grids(TH, TW)
    nz = inside = tiles = 0
    for b in range(3):
        blk, ct = tpr._dense_chunks(r[b], n[b], cap)
        x0, y0 = tpr.tile_origin(ct, N_TX, TH, TW)
        s = tpr._chunk_setup(blk, c[b].expand(ct.numel(), 16), x0, y0, 0.001, 10.0)
        cov, *_ = tpr._chunk_coverage(s, px, py, sharpness)
        band = tpr.band_mask(s, px, py, sharpness)
        assert not (cov > 0)[~band].any()
        nz, inside = nz + int((cov > 0).sum()), inside + int(band.sum())
        tiles += int(band.any(-1).sum()) * TH * TW
    assert 0 < nz <= inside < tiles  # the band is far tighter than whole tiles


@pytest.mark.parametrize("th,tw,regions", [(16, 32, 2), (16, 64, 4), (32, 128, 16),
                                           (64, 128, 32), (20, 40, 6), (8, 8, 1)])
def test_n_sub_counts_forward_regions(th, tw, regions):
    """The forward kernels run one block per 8×32 pixel region of a tile
    (fwd_blocks, csrc/pose_raster_fwd.cuh); the wrappers size the per-region
    loss partials by n_sub."""
    assert tpr.n_sub(tpr.Meta(th, tw, 1, 64, 64)) == regions
