"""CUDA kernels of easyhec_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU with nvcc (the kernels are compiled from
easyhec_torch/ops/csrc at first use); without one they skip. They import no
JAX, so on a machine without JAX run them with the repository conftest
disabled:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum over 128 lanes and a tile's pixels in another order
than the plain versions (and nvcc contracts multiply-adds into FMAs), so
the loss agrees to rtol 1e-5 and the pose partials to 1e-4 of their
largest magnitude; the integer bin state agrees exactly. acc at or above 2
is unspecified (saturation early-out): min(acc, 2) is compared.
"""
import numpy as np
import pytest
import torch

from easyhec_torch.geometry import se3
from easyhec_torch.ops import pose_raster as pr
from easyhec_torch.ops import pose_raster_compact as prc
from easyhec_torch.ops.pose_raster import tile_image
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.render.fused import (
    build_compact_state,
    build_fused_state,
    cam_rows,
    loss_fused,
)
from easyhec_torch.robot import make_box, make_cylinder

pytestmark = pytest.mark.cuda

H, W = 64, 96
CFG = TileConfig(16, 32, 128, binner="count", fused=True, compact_chunks=16,
                 margin=2.0, cull_backfaces=True, bin_big_k=64,
                 bin_subsort_rows=True)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(device, band_only, B=3):
    rng = np.random.default_rng(0)
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    r = RobotRenderer(meshes, H, W, tile=CFG._replace(bwd_band_only=band_only),
                      device=device)
    lp = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    lp[1:, 1, :3, 3] += rng.uniform(-0.2, 0.2, (B - 1, 3)).astype(np.float32)
    xi = np.array([0.02, -0.03, 1.2, 0.05, -0.08, 0.03], np.float32)
    K = np.array([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]], np.float32)
    target = (rng.random((B, H, W)) > 0.6).astype(np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in
         dict(lp=lp, xi=xi, K=K, target=target).items()}
    st = build_compact_state(r, se3.exp(t["xi"]), t["lp"], t["K"])
    return r, st, t


@pytest.mark.parametrize("band_only", [False, True])
def test_kernels_match_plain(dev, band_only):
    r, st, t = _scene(dev, band_only)
    assert not bool(st.overflow)
    B = t["lp"].shape[0]
    cam = cam_rows(se3.exp(t["xi"] + 0.01), t["K"], B).contiguous()
    ref = tile_image(t["target"], 16, 32).contiguous()
    meta = prc.Meta(16, 32, 3, H, W, 1.0, 0.001, 10.0, band_only)
    args = (cam, st.rec, st.nlive, st.ctmap, st.ncu, ref, meta)
    lk, acck = prc.loss_fwd_compact_cuda(*args)
    lp_, accp = prc.loss_fwd_compact_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(lk.cpu(), lp_.cpu(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(torch.clamp(acck, max=2).cpu(),
                               torch.clamp(accp, max=2).cpu(), atol=1e-5)
    gb = torch.linspace(0.5, 1.5, B, device=dev)
    bargs = (cam, st.rec, st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref, acck, gb, meta)
    pk = prc.loss_bwd_compact_cuda(*bargs)
    pp = prc.loss_bwd_compact_plain(*bargs)
    torch.cuda.synchronize()
    scale = pp.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(pk.cpu(), pp.cpu(), rtol=0, atol=1e-4 * scale)


def test_loss_fused_cuda_matches_cpu_and_counts_launches(dev):
    # One bin state (built on the CPU) drives both devices: a state built on
    # the card may bin a bbox within an ulp of a tile edge differently
    # (cuBLAS and the CPU BLAS round the pose products differently).
    _, st_cpu, _ = _scene(torch.device("cpu"), True)
    _, st_dev, _ = _scene(dev, True)
    assert not bool(st_dev.overflow)
    assert abs(int(st_dev.counts.sum()) - int(st_cpu.counts.sum())) <= 2
    losses, grads = [], []
    for d in (dev, torch.device("cpu")):
        r, _, t = _scene(d, True)
        st = type(st_cpu)(*(x.to(d) for x in st_cpu))
        xi = (t["xi"] + 0.01).requires_grad_()
        f0, b0 = prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches
        loss = loss_fused(r, se3.exp(xi), t["lp"], t["K"], masks_ref=t["target"],
                          state=st).mean()
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert prc.loss_fwd_compact_cuda.launches == f0 + 1
            assert prc.loss_bwd_compact_cuda.launches == b0 + 1
        else:
            assert prc.loss_fwd_compact_cuda.launches == f0
        losses.append(loss.item())
        grads.append(xi.grad.cpu().numpy())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4,
                               atol=1e-4 * np.abs(grads[1]).max())


# The dense kernels (K1 loss, K4 silhouette) at an uneven 60×90 image: the
# last tile row and column are cropped. cap 96 is padded to 128 slots.
HD, WD = 60, 90
DENSE = TileConfig(16, 32, 96, binner="count", fused=True, margin=2.0)


def _dense_scene(device, band_only, B=3):
    rng = np.random.default_rng(1)
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    r = RobotRenderer(meshes, HD, WD, tile=DENSE._replace(bwd_band_only=band_only),
                      device=device)
    lp = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    lp[1:, 1, :3, 3] += rng.uniform(-0.2, 0.2, (B - 1, 3)).astype(np.float32)
    xi = np.array([0.02, -0.03, 1.2, 0.05, -0.08, 0.03], np.float32)
    K = np.array([[80.0, 0, 45], [0, 80.0, 30], [0, 0, 1]], np.float32)
    target = (rng.random((B, HD, WD)) > 0.6).astype(np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in
         dict(lp=lp, xi=xi, K=K, target=target).items()}
    st = build_fused_state(r, se3.exp(t["xi"]), t["lp"], t["K"])
    return r, st, t


@pytest.mark.parametrize("band_only", [False, True])
def test_dense_kernels_match_plain(dev, band_only):
    r, st, t = _dense_scene(dev, band_only)
    assert not bool(st.overflow.any())
    B = t["lp"].shape[0]
    rec = pr._pad_records(st.rec, st.counts)
    counts = pr.i32(st.counts)
    cam = cam_rows(se3.exp(t["xi"] + 0.01), t["K"], B).contiguous()
    ref = tile_image(t["target"], 16, 32).contiguous()
    meta = pr.Meta(16, 32, 3, HD, WD, 1.0, 0.001, 10.0, band_only)

    def close(a, b, **kw):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **kw)

    lk, acck = pr.loss_fwd_cuda(cam, rec, counts, ref, meta)   # K1f
    lp_, accp = pr.loss_fwd_plain(cam, rec, counts, ref, meta)
    torch.cuda.synchronize()
    close(lk, lp_, rtol=1e-5, atol=1e-3)
    close(acck.clamp(max=2), accp.clamp(max=2), atol=1e-5)
    gb = torch.linspace(0.5, 1.5, B, device=dev)
    pk = pr.loss_bwd_cuda(cam, rec, counts, ref, acck, gb, meta)  # K1b
    pp = pr.loss_bwd_plain(cam, rec, counts, ref, acck, gb, meta)
    torch.cuda.synchronize()
    assert pp.abs().max() > 0
    close(pk, pp, rtol=0, atol=1e-4 * pp.abs().max().item())

    sk, acc_s = pr.sil_fwd_cuda(cam, rec, counts, meta)  # K4f
    sp, _ = pr.sil_fwd_plain(cam, rec, counts, meta)
    torch.cuda.synchronize()
    close(sk, sp, atol=1e-5)
    close(acc_s.clamp(max=2), acck.clamp(max=2), atol=0)  # the same coverage
    g = torch.randn(sk.shape, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    qk = pr.sil_bwd_cuda(cam, rec, counts, acc_s, g, meta)  # K4b
    qp = pr.sil_bwd_plain(cam, rec, counts, acc_s, g, meta)
    torch.cuda.synchronize()
    assert qp.abs().max() > 0
    close(qk, qp, rtol=0, atol=1e-4 * qp.abs().max().item())


def test_dense_route_counts_launches(dev):
    r, st, t = _dense_scene(dev, True)
    names = ("loss_fwd_cuda", "loss_bwd_cuda", "sil_fwd_cuda", "sil_bwd_cuda")
    before = [getattr(pr, n).launches for n in names]
    xi = (t["xi"] + 0.01).requires_grad_()
    loss = loss_fused(r, se3.exp(xi), t["lp"], t["K"], masks_ref=t["target"],
                      state=st).mean()
    img = r.silhouette(se3.exp(xi), t["lp"], t["K"], bin_state=st)
    (loss + img.sum()).backward()
    torch.cuda.synchronize()
    assert torch.isfinite(xi.grad).all() and xi.grad.abs().max() > 0
    after = [getattr(pr, n).launches for n in names]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]


# Tiles above one block of threads (32×128 = 4096 pixels, 16 regions of 8×32
# pixels in the forwards): the dense and compact kernels against their plain
# versions.
# Tile-local edge offsets reach the tile width (128 px, ulp 1.5e-5), so FMA
# contraction moves acc and the image by up to a few such ulps: atol 1e-4.
BIG = TileConfig(32, 128, 256, binner="count", fused=True, margin=2.0,
                 compact_chunks=16)
HB, WB = 80, 200  # 3×2 tiles, both cropped


@pytest.mark.parametrize("band_only", [False, True])
def test_kernels_large_tiles_match_plain(dev, band_only):
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    rng = np.random.default_rng(4)
    B = 2
    lp = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    lp[1:, 1, :3, 3] += rng.uniform(-0.2, 0.2, (B - 1, 3)).astype(np.float32)
    K = torch.tensor([[150.0, 0, 100], [0, 150.0, 40], [0, 0, 1]], device=dev)
    xi = torch.tensor([0.02, -0.03, 1.2, 0.05, -0.08, 0.03], device=dev)
    lpt = torch.from_numpy(lp).to(dev)
    target = torch.from_numpy((rng.random((B, HB, WB)) > 0.6).astype(np.float32)).to(dev)
    tile = BIG._replace(bwd_band_only=band_only)
    cam = cam_rows(se3.exp(xi + 0.01), K, B).contiguous()
    ref = tile_image(target, 32, 128).contiguous()
    meta = pr.Meta(32, 128, 2, HB, WB, 1.0, 0.001, 10.0, band_only)
    assert pr.n_sub(meta) == 16
    gb = torch.linspace(0.5, 1.5, B, device=dev)

    def close(a, b, **kw):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **kw)

    # compact K2f / K2b
    st = build_compact_state(RobotRenderer(meshes, HB, WB, tile=tile, device=dev),
                             se3.exp(xi), lpt, K)
    assert not bool(st.overflow)
    args = (cam, st.rec, st.nlive, st.ctmap, st.ncu, ref, meta)
    lk, acck = prc.loss_fwd_compact_cuda(*args)
    lp_, accp = prc.loss_fwd_compact_plain(*args)
    close(lk, lp_, rtol=1e-5, atol=1e-3)
    close(acck.clamp(max=2), accp.clamp(max=2), atol=1e-4)
    bargs = (cam, st.rec, st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref, acck, gb, meta)
    pk, pp = prc.loss_bwd_compact_cuda(*bargs), prc.loss_bwd_compact_plain(*bargs)
    close(pk, pp, rtol=0, atol=1e-4 * pp.abs().max().item())

    # dense K1f / K1b / K4f / K4b
    dst = build_fused_state(RobotRenderer(meshes, HB, WB, tile=tile._replace(compact_chunks=0),
                                          device=dev), se3.exp(xi), lpt, K)
    rec, counts = pr._pad_records(dst.rec, dst.counts), pr.i32(dst.counts)
    lk, acck = pr.loss_fwd_cuda(cam, rec, counts, ref, meta)
    lp_, accp = pr.loss_fwd_plain(cam, rec, counts, ref, meta)
    close(lk, lp_, rtol=1e-5, atol=1e-3)
    close(acck.clamp(max=2), accp.clamp(max=2), atol=1e-4)
    pk = pr.loss_bwd_cuda(cam, rec, counts, ref, acck, gb, meta)
    pp = pr.loss_bwd_plain(cam, rec, counts, ref, acck, gb, meta)
    assert pp.abs().max() > 0
    close(pk, pp, rtol=0, atol=1e-4 * pp.abs().max().item())
    sk, acc_s = pr.sil_fwd_cuda(cam, rec, counts, meta)
    close(sk, pr.sil_fwd_plain(cam, rec, counts, meta)[0], atol=1e-4)
    g = torch.randn(sk.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    qk = pr.sil_bwd_cuda(cam, rec, counts, acc_s, g, meta)
    qp = pr.sil_bwd_plain(cam, rec, counts, acc_s, g, meta)
    close(qk, qp, rtol=0, atol=1e-4 * qp.abs().max().item())


# The backward kernels (K2b, K1b, K4b: one thread per record slot, the tile's
# live cotangent pixels listed in shared memory, swept in passes of 4096
# pixels) on inputs that reach each of their branches. The box and cylinder
# are subdivided to 5 cm edges (2,496 triangles), so tiles hold up to 20
# chunks, walked by one block (cap 4096), most counts are no multiple of
# 128, and the compact budget of
# 64 chunks leaves padding chunks (nlive = 0). The reference is uniform in
# [0.1, 0.9], so without band_only every pixel with acc <= 1 is live (over
# 1024 pixels per 32x128 tile; 64x128 tiles take two passes of the list).
# Frame 1 has no live pixel (its reference is its own clipped coverage, its
# image cotangent zero); frame 2 looks away from the arm (every triangle
# behind the near plane, every slot invalid). Tolerance: dcam within
# 1e-3 of max|dcam| (summation order over slots and pixels); two launches
# on the same inputs agree bit for bit (fixed-order sums, no atomics).
@pytest.mark.parametrize("th,tw,band_only", [(16, 32, True), (32, 128, False),
                                             (32, 128, True), (64, 128, False)])
def test_bwd_kernels_branches(dev, th, tw, band_only):
    from easyhec_torch.robot.mesh import subdivide_to_max_edge

    meshes = [subdivide_to_max_edge(make_box((0.15, 0.15, 0.3)), 0.05),
              subdivide_to_max_edge(make_cylinder(0.05, 0.4, sections=12), 0.05)]
    rng = np.random.default_rng(4)
    B = 3
    lp = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    lp[1:, 1, :3, 3] += rng.uniform(-0.2, 0.2, (B - 1, 3)).astype(np.float32)
    lpt = torch.from_numpy(lp).to(dev)
    K = torch.tensor([[150.0, 0, 100], [0, 150.0, 40], [0, 0, 1]], device=dev)
    xi = torch.tensor([0.02, -0.03, 1.2, 0.05, -0.08, 0.03], device=dev)
    tile = TileConfig(th, tw, 4096, binner="count", fused=True, margin=2.0,
                      compact_chunks=64, bwd_band_only=band_only)
    n_tx = -(-WB // tw)
    T = -(-HB // th) * n_tx
    meta = pr.Meta(th, tw, n_tx, HB, WB, 1.0, 0.001, 10.0, band_only)
    cam = cam_rows(se3.exp(xi + 0.01), K, B).clone()
    cam[2, 8:12] = -cam[2, 8:12]  # frame 2: every camera z < 0
    cam = cam.contiguous()
    ref = torch.from_numpy(rng.uniform(0.1, 0.9, (B, T, th, tw)).astype(np.float32)).to(dev)
    gb = torch.linspace(0.5, 1.5, B, device=dev)

    def check(name, fn, plain_fn, args):
        k1, k2 = fn(*args), fn(*args)
        want = plain_fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(k1, k2), f"{name}: two launches differ"
        assert (k1[1:] == 0).all() and (want[1:] == 0).all(), name  # frames 1, 2
        scale = want.sum(1).abs().max().item()
        assert scale > 0
        np.testing.assert_allclose(k1.sum(1).cpu().numpy(), want.sum(1).cpu().numpy(),
                                   rtol=0, atol=1e-3 * scale, err_msg=name)
        return k1

    # dense K1b / K4b
    dst = build_fused_state(RobotRenderer(meshes, HB, WB, tile=tile._replace(compact_chunks=0),
                                          device=dev), se3.exp(xi), lpt, K)
    assert not bool(dst.overflow.any())
    rec, counts = pr._pad_records(dst.rec, dst.counts), pr.i32(dst.counts)
    assert ((counts > 128) & (counts % 128 != 0)).any()
    acc = pr.loss_fwd_cuda(cam, rec, counts, ref, meta)[1]
    ref_d = ref.clone()
    ref_d[1] = acc[1].clamp(0.0, 1.0)  # frame 1: e = 0 on every pixel
    gp = pr.loss_cotangent(acc.reshape(B, T, -1), ref_d.reshape(B, T, -1), gb[:, None, None],
                           torch.arange(T, device=dev), meta)
    live = (gp != 0).sum(-1)
    assert (live[1] == 0).all() and live[0].max() > 0
    if not band_only and th * tw >= 4096:
        assert live[0].max() > 1024
    check("K1b", pr.loss_bwd_cuda, pr.loss_bwd_plain, (cam, rec, counts, ref_d, acc, gb, meta))
    _, acc_s = pr.sil_fwd_cuda(cam, rec, counts, meta)
    g = torch.randn(acc_s.shape, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    g[1] = 0.0
    check("K4b", pr.sil_bwd_cuda, pr.sil_bwd_plain, (cam, rec, counts, acc_s, g, meta))

    # compact K2b, with padding chunks
    cst = build_compact_state(RobotRenderer(meshes, HB, WB, tile=tile, device=dev),
                              se3.exp(xi), lpt, K)
    assert not bool(cst.overflow) and (cst.bwd_nlive == 0).any()
    acc_c = prc.loss_fwd_compact_cuda(cam, cst.rec, cst.nlive, cst.ctmap, cst.ncu, ref,
                                      meta)[1]
    ref_c = ref.clone()
    ref_c[1] = acc_c[1].clamp(0.0, 1.0)
    cargs = (cam, cst.rec, cst.bwd_nlive, cst.bwd_ctmap, cst.bwd_cpos, ref_c, acc_c, gb, meta)
    ck = check("K2b", prc.loss_bwd_compact_cuda, prc.loss_bwd_compact_plain, cargs)
    assert (ck[cst.bwd_nlive == 0] == 0).all()


# The unfused tile rasterizer (K5f, and K5b in its dense and counted
# epilogues) on real records of the unfused route, at a bins' cap of 200
# (run as 256 by K5; the counted K5b indexes tile*200 + slot), on tiles of
# 16x32, 32x48, 32x128 (4096 pixels: 16 regions in the forward, one
# 4096-pixel live list in the backward) and 8x8. Tolerances: the image and
# min(acc, 2) atol 1e-5 (summation order over slots); dtri and dg 1e-4 of
# their largest entry (summation order over pixels); two launches agree bit
# for bit (no atomics).
UNFUSED = TileConfig(16, 32, 200, binner="count", margin=2.0)


def _k5_check(dev, rec, counts, meta, g, n_tx=None, cap_bins=None):
    """K5f, the dense K5b and (with n_tx, cap_bins) the counted K5b against
    their plain versions, each launched twice; -> (acc, counted dg)."""
    from easyhec_torch.ops import tile_raster as tr_

    def twice(fn, *args):
        a, b = fn(*args), fn(*args)
        torch.cuda.synchronize()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x.clamp(max=2), y.clamp(max=2)), "two launches differ"
        return a

    ok, acck = twice(tr_.tile_fwd_cuda, rec, counts, meta)
    op, accp = tr_.tile_fwd_plain(rec, counts, meta)
    np.testing.assert_allclose(ok.cpu(), op.cpu(), atol=1e-5)
    np.testing.assert_allclose(acck.clamp(max=2).cpu(), accp.clamp(max=2).cpu(), atol=1e-5)
    assert (acck[counts == 0] == 0).all() and (ok[counts == 0] == 0).all()
    dk = twice(tr_.tile_bwd_cuda, rec, counts, acck, g, meta)
    dp = tr_.tile_bwd_plain(rec, counts, acck, g, meta)
    scale = dp.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(dk.cpu(), dp.cpu(), rtol=0, atol=1e-4 * scale)
    assert (dk[..., 13:, :] == 0).all()
    if n_tx is None:
        return acck, None
    # the counted dg is defined only where the kernel writes it: the slots
    # below each tile's count, and the zero column
    slot = torch.arange(cap_bins, device=dev)
    written = (slot < counts[..., None]).reshape(counts.shape[0], 1, -1)  # [B, 1, T*cap_bins]
    written = torch.cat([written, torch.ones_like(written[..., :1])], -1)
    written = written.expand(-1, 13, -1)
    ck = twice(lambda *a: tr_.tile_bwd_counted_cuda(*a)[written],
               rec, counts, acck, g, meta, n_tx, cap_bins)
    cp = tr_.tile_bwd_counted_plain(rec, counts, acck, g, meta, n_tx, cap_bins)[written]
    np.testing.assert_allclose(ck.cpu(), cp.cpu(), rtol=0, atol=1e-4 * cp.abs().max().item())
    return acck, ck


@pytest.mark.parametrize("th,tw", [(16, 32), (32, 48), (32, 128), (8, 8)])
def test_tile_raster_matches_plain(dev, th, tw):
    from easyhec_torch.ops import tile_raster as tr_
    from easyhec_torch.render.binning import fields_and_bins, pack_records_counted

    r, _, t = _dense_scene(dev, False)
    r.tile = UNFUSED._replace(tile_h=th, tile_w=tw)
    B = t["lp"].shape[0]
    tris = r._triangles_soa(r.camera_link_poses(se3.exp(t["xi"]), t["lp"]), t["K"])
    fields, st = fields_and_bins(tris, HD, WD, r.tile)
    assert not bool(st.overflow.any())
    n_tx = -(-WD // tw)
    rec = tr_.pad_cap(pack_records_counted(fields, st.idx, st.q, n_tx, th, tw, 16)).contiguous()
    assert rec.shape[-1] == 256 and B == 3
    counts = st.counts.contiguous()
    meta = tr_.TileMeta(th, tw, 1.0)
    g = torch.randn((B, counts.shape[1], th, tw),
                    generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    _k5_check(dev, rec, counts, meta, g, n_tx, 200)


def _full_cap_records(dev, B, th, tw, H, W, cap, seed=9):
    """K5 records [B, T, 16, cap] of `cap` random small triangles in every
    tile, all slots live (counts = cap): the global search's saturated
    tiles. Tile-local, spread a few pixels past the tile."""
    from easyhec_torch.render.projection import TrianglesSoA
    from easyhec_torch.render.tiled import _edge_fields_soa

    rng = np.random.default_rng(seed)
    T = -(-H // th) * -(-W // tw)
    n = B * T * cap
    c = rng.uniform([-3.0, -3.0], [tw + 3.0, th + 3.0], (n, 2))
    uv = torch.from_numpy((c[:, None, :] + rng.uniform(-2.5, 2.5, (n, 3, 2))).astype(np.float32))
    soa = TrianglesSoA(u=uv[..., 0].T, v=uv[..., 1].T, z=torch.ones(3, n),
                       valid=torch.ones(n, dtype=torch.bool))
    fl = torch.stack(_edge_fields_soa(soa))  # [13, n]
    rec = torch.cat([fl, torch.zeros(3, n)]).reshape(16, B, T, cap).permute(1, 2, 0, 3)
    counts = torch.full((B, T), cap, dtype=torch.int32)
    return rec.contiguous().to(dev), counts.to(dev)


def test_tile_raster_search_shapes(dev):
    """K5 at the global search's scoring shapes: 80x60 frames (16x32 tiles,
    T = 12, the last row and column partial) with every tile at cap 1664,
    a batch of 16 (the refinement's)."""
    from easyhec_torch.ops import tile_raster as tr_

    rec, counts = _full_cap_records(dev, 16, 16, 32, 60, 80, 1664)
    assert rec.shape == (16, 12, 16, 1664)
    meta = tr_.TileMeta(16, 32, 1.0)
    g = torch.randn((16, 12, 16, 32), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    acc, _ = _k5_check(dev, rec, counts, meta, g, 3, 1664)
    assert (acc < 1).any() and (acc > 1).any()


def test_counted_bwd_writes_only_what_the_gather_reads(dev):
    """The counted K5b launched through its binding into a NaN-filled dg
    (only the zero column set): the gather at q reads no entry the kernel
    left unwritten, so dfields is finite and equals the plain version's."""
    from easyhec_torch.ops import tile_raster as tr_
    from easyhec_torch.render.binning import _gather_at_q, fields_and_bins, pack_records_counted

    r, _, t = _dense_scene(dev, False)
    r.tile = UNFUSED
    tris = r._triangles_soa(r.camera_link_poses(se3.exp(t["xi"]), t["lp"]), t["K"])
    fields, st = fields_and_bins(tris, HD, WD, r.tile)
    n_tx = -(-WD // 32)
    rec = tr_.pad_cap(pack_records_counted(fields, st.idx, st.q, n_tx, 16, 32, 16)).contiguous()
    counts = st.counts.contiguous()
    meta = tr_.TileMeta(16, 32, 1.0)
    _, acc = tr_.tile_fwd_cuda(rec, counts, meta)
    g = torch.randn(acc.shape, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    B, T = counts.shape
    dg = torch.full((B, 13, T * 200 + 1), float("nan"), device=dev)
    dg[:, :, -1] = 0.0
    tr_._bwd_launch(1, rec, counts, acc, g, dg, meta, n_tx, 200)
    got = _gather_at_q(dg, st.q)
    want = _gather_at_q(tr_.tile_bwd_counted_plain(rec, counts, acc, g, meta, n_tx, 200), st.q)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.isnan(dg).any()
    scale = want.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-4 * scale)


def test_unfused_silhouette_cuda_matches_cpu_and_counts_launches(dev):
    from easyhec_torch.ops import tile_raster as tr_

    out = []
    for d in (dev, torch.device("cpu")):
        r, _, t = _dense_scene(d, False)
        r.tile = UNFUSED
        xi = (t["xi"] + 0.01).requires_grad_()
        kernels = (tr_.tile_fwd_cuda, tr_.tile_bwd_counted_cuda, tr_.tile_bwd_cuda)
        before = [k.launches for k in kernels]
        img = r.silhouette(se3.exp(xi), t["lp"], t["K"])
        ((img - t["target"]) ** 2).sum().backward()
        if d.type == "cuda":  # K5f and the counted K5b; no dense d(record)
            torch.cuda.synchronize()
            assert [k.launches - n for k, n in zip(kernels, before)] == [1, 1, 0]
        out.append((img.detach().cpu().numpy(), xi.grad.cpu().numpy()))
    (ik, gk), (ip, gp) = out
    np.testing.assert_allclose(ik, ip, atol=1e-4)
    np.testing.assert_allclose(gk, gp, rtol=1e-3, atol=1e-3 * np.abs(gp).max())


# The forward kernels (K1f, K4f, K2f and K3 through compact_tile_acc: one
# block per 8x32 region of a tile, slots set up in passes of 512 and culled
# against the region, each 4x8 warp patch adding only the records whose
# band-dilated bbox reaches it) on records made to reach each branch: an
# empty tile, counts that are no multiple of 128 and above one pass of 512,
# a stack of tile-covering quads ahead of small triangles (the saturation
# early-out, whole tiles and half tiles), slots behind the near plane, slots
# whose bbox misses the tile or most of its patches, compact padding chunks
# (nlive = 0) and a frame with ncu = 0 (frame 2 has no slot at all). The
# 40x56 image is not divided by its tiles. The 8x8 tiles of a 264x320 image
# give T = 1320 and ~4,100 compact chunks a frame: more than the kernels' list
# window of 1024 tiles (or chunks), with tile runs of chunks that cross a
# window's end. Tolerances: the per-frame loss
# rtol 1e-4 and min(acc, 2) atol 1e-3 (summation order over pixels); two
# launches on the same inputs agree bit for bit (fixed-order sums, no
# atomics).
def _fwd_records(th, tw, H, W, seed=5):
    """Dense (cam [3, 16], rec [3, 12, T*cap], counts [3, T]) numpy arrays:
    tile-local triangles, back-projected through a camera at the origin."""
    rng = np.random.default_rng(seed)
    n_ty, n_tx = -(-H // th), -(-W // tw)
    T, cap, B = n_ty * n_tx, 1024, 3
    f, cx, cy = 90.0, W / 2, H / 2
    cam = np.zeros((B, 16), np.float32)
    cam[:, [0, 5, 10]] = 1.0
    cam[:, 12:] = f, f, cx, cy
    rec = np.zeros((B, 12, T * cap), np.float32)
    counts = np.zeros((B, T), np.int32)

    def put(b, t, uv, z):  # uv [n, 3, 2] image pixels, z [n] depths
        n = uv.shape[0]
        X = np.stack([(uv[..., 0] - cx) * z[:, None] / f, (uv[..., 1] - cy) * z[:, None] / f,
                      np.broadcast_to(z[:, None], (n, 3)), np.ones((n, 3))], -1)
        s = t * cap + counts[b, t]
        rec[b, :, s:s + n] = X.reshape(n, 12).T
        counts[b, t] += n

    def small(n, ox, oy, spread, size=4.0):
        c = np.stack([ox + rng.uniform(-spread, tw + spread, n),
                      oy + rng.uniform(-spread, th + spread, n)], -1)
        return c[:, None, :] + rng.uniform(-size, size, (n, 3, 2))

    for b in range(2):
        for t in range(T):
            ox, oy = (t % n_tx) * tw, (t // n_tx) * th
            if (t + b) % 4 == 0:
                continue  # an empty tile
            if (t + b) % 4 == 1:  # tile-covering quads ahead: saturation
                half = t % 2  # the quads cover the whole tile or its top half
                x1, y1 = ox + tw + 2, oy + (th // 2 if half else th) + 2
                q = np.array([[[ox - 2, oy - 2], [x1, oy - 2], [x1, y1]],
                              [[ox - 2, oy - 2], [x1, y1], [ox - 2, y1]]], np.float32)
                put(b, t, np.tile(q, (150, 1, 1)), np.full(300, 1.0, np.float32))
            n = int(rng.integers(130, 330))
            put(b, t, small(n, ox, oy, 6.0), rng.uniform(0.6, 1.5, n).astype(np.float32))
            put(b, t, small(40, ox, oy, 6.0), np.full(40, -0.5, np.float32))  # behind near
            put(b, t, small(30, ox, oy, 60.0, 2.0), np.full(30, 1.0, np.float32))  # mostly off
            if (t + b) % 4 == 3:  # a long stack: two passes of 512
                put(b, t, small(200, ox, oy, 2.0), rng.uniform(0.6, 1.5, 200).astype(np.float32))
    return cam, rec, counts


def _compact_from_dense(rec, counts, cap, pad=3):
    """Chunk-aligned compact records and map of dense (rec, counts), as
    build_compact_state packs them, with `pad` padding chunks at least."""
    B, T = counts.shape
    cpt = -(-counts // 128)
    nc = int(cpt.sum(-1).max()) + pad
    rc = np.zeros((B, 12, nc * 128), np.float32)
    nlive = np.zeros((B, nc), np.int32)
    ctmap = np.full((B, nc), T - 1, np.int32)
    ncu = cpt.sum(-1).astype(np.int32)
    for b in range(B):
        c = 0
        for t in range(T):
            n = int(counts[b, t])
            rc[b, :, c * 128:c * 128 + n] = rec[b, :, t * cap:t * cap + n]
            for j in range(int(cpt[b, t])):
                nlive[b, c] = min(128, n - 128 * j)
                ctmap[b, c] = t
                c += 1
        if c:
            ctmap[b, c:] = ctmap[b, c - 1]
    return rc, nlive, ctmap, ncu


@pytest.mark.parametrize("th,tw,H,W", [(16, 32, 48, 96), (32, 128, 64, 256),
                                       (16, 32, 40, 56), (8, 8, 264, 320)])
def test_fwd_kernels_branches(dev, th, tw, H, W):
    cam_np, rec_np, counts_np = _fwd_records(th, tw, H, W)
    n_tx, T = -(-W // tw), counts_np.shape[1]
    cap = rec_np.shape[-1] // T
    assert counts_np.max() > 512 and (counts_np[:2] == 0).any() and (counts_np[2] == 0).all()
    assert ((counts_np % 128 != 0) & (counts_np > 0)).any()
    rc_np, nlive_np, ctmap_np, ncu_np = _compact_from_dense(rec_np, counts_np, cap)
    assert (nlive_np == 0).any() and ncu_np[2] == 0
    if T > 1024:  # runs of one tile's chunks across the 1024-chunk windows
        cross = [(b, c) for b in range(2) for c in range(1024, int(ncu_np[b]), 1024)
                 if ctmap_np[b, c - 1] == ctmap_np[b, c]]
        assert cross and ncu_np[:2].min() > 2048, (cross, ncu_np)
    rng = np.random.default_rng(6)
    ref_np = (rng.random((3, T, th, tw)) > 0.5).astype(np.float32)
    cam, rec, counts, ref, rc, nlive, ctmap, ncu = (
        torch.from_numpy(a).to(dev) for a in
        (cam_np, rec_np, counts_np, ref_np, rc_np, nlive_np, ctmap_np, ncu_np))
    meta = pr.Meta(th, tw, n_tx, H, W, 1.0, 0.001, 10.0, True)

    def same_twice(name, fn, args):
        a, b = fn(*args), fn(*args)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x.clamp(max=2), y.clamp(max=2)), f"{name}: two launches differ"
        return a

    def close_loss(name, lk, lp_):
        fk, fp = lk.sum(-1).cpu().numpy(), lp_.sum(-1).cpu().numpy()
        np.testing.assert_allclose(fk, fp, rtol=1e-4, err_msg=name)

    def close_acc(name, ak, ap):
        np.testing.assert_allclose(ak.clamp(max=2).cpu().numpy(), ap.clamp(max=2).cpu().numpy(),
                                   atol=1e-3, err_msg=name)

    # dense K1f / K4f
    lk, acck = same_twice("K1f", pr.loss_fwd_cuda, (cam, rec, counts, ref, meta))
    lp_, accp = pr.loss_fwd_plain(cam, rec, counts, ref, meta)
    close_loss("K1f", lk, lp_)
    close_acc("K1f", acck, accp)
    assert (accp.amax(dim=(-2, -1)) >= 2).any() and (acck[counts == 0] == 0).all()
    sk, acc_s = same_twice("K4f", pr.sil_fwd_cuda, (cam, rec, counts, meta))
    sp, _ = pr.sil_fwd_plain(cam, rec, counts, meta)
    close_acc("K4f", sk, sp)
    close_acc("K4f acc", acc_s, accp)

    # compact K2f, and K3 with a zero reference
    lck, acc_ck = same_twice("K2f", prc.loss_fwd_compact_cuda,
                             (cam, rc, nlive, ctmap, ncu, ref, meta))
    lcp, acc_cp = prc.loss_fwd_compact_plain(cam, rc, nlive, ctmap, ncu, ref, meta)
    close_loss("K2f", lck, lcp)
    close_acc("K2f", acc_ck, acc_cp)
    close_acc("K2f vs K1f", acc_ck, acck)
    assert (lck[2] == 0).all() and (acc_ck[2] == 0).all()  # ncu = 0
    k3 = prc.compact_tile_acc(cam, rc, nlive, ctmap, ncu, T, th, tw, n_tx, H, W)
    _, k3p = prc.loss_fwd_compact_plain(cam, rc, nlive, ctmap, ncu, torch.zeros_like(ref), meta)
    close_acc("K3", k3, k3p)


# The boundary-prefix backward map (tile.bwd_chunks > 0 with bwd_band_only):
# build_compact_state runs K3 (compact_tile_acc) on the card to find the
# tiles that can hold a band pixel, and K2b runs only on their chunks. K2b on
# that map against its plain version on the same map, and against K2b on the
# forward's full map: the chunks the map leaves out carry no band pixel, so
# dcam is the same up to summation order (1e-3 of max|dcam|).
def test_boundary_prefix_map_backward(dev):
    tile = CFG._replace(bwd_band_only=True, bwd_chunks=16)
    r, _, t = _scene(dev, True)
    st = build_compact_state(RobotRenderer(r.meshes, H, W, tile=tile, device=dev),
                             se3.exp(t["xi"]), t["lp"], t["K"])
    full = build_compact_state(r, se3.exp(t["xi"]), t["lp"], t["K"])
    assert not bool(st.overflow)
    nb = (st.bwd_nlive > 0).sum(-1)
    assert (nb <= st.ncu).all() and nb.sum() > 0
    B = t["lp"].shape[0]
    cam = cam_rows(se3.exp(t["xi"] + 0.01), t["K"], B).contiguous()
    ref = tile_image(t["target"], 16, 32).contiguous()
    meta = prc.Meta(16, 32, 3, H, W, 1.0, 0.001, 10.0, True)
    acc = prc.loss_fwd_compact_cuda(cam, st.rec, st.nlive, st.ctmap, st.ncu, ref, meta)[1]
    gb = torch.linspace(0.5, 1.5, B, device=dev)
    args = (cam, st.rec, st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref, acc, gb, meta)
    pk = prc.loss_bwd_compact_cuda(*args).sum(1)
    pp = prc.loss_bwd_compact_plain(*args).sum(1)
    fargs = (cam, full.rec, full.bwd_nlive, full.bwd_ctmap, full.bwd_cpos, ref, acc, gb, meta)
    pf = prc.loss_bwd_compact_cuda(*fargs).sum(1)
    torch.cuda.synchronize()
    scale = pp.abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(pk.cpu(), pp.cpu(), rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(pk.cpu(), pf.cpu(), rtol=0, atol=1e-3 * scale)


@pytest.mark.parametrize("shared", [False, True], ids=["exact", "shared"])
def test_explorer_score_cuda_matches_cpu_and_counts_launches(dev, shared):
    """SpaceExplorer._score (one K3 launch per batch and hypothesis) on the
    card against the plain path on the CPU: the variance to 1e-4 of its
    largest value, feasibility equal."""
    from pathlib import Path

    from easyhec_torch.models.explorer import SpaceExplorer, draw_hypotheses_and_candidates
    from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf

    names = ["base", "upper", "fore"]
    model = parse_urdf(Path(__file__).resolve().parents[1] / "assets" / "mini_arm.urdf")
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=names)
    lim = chain.joint_limits * np.float32(0.9)
    _, q = draw_hypotheses_and_candidates(0, 1, 1, 12, lim[:, 0], lim[:, 1])
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    hyp = (se3.log(torch.from_numpy(Tc)).numpy()
           + np.random.default_rng(0).normal(0, 0.01, (4, 6))).astype(np.float32)
    K = np.array([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]], np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        r = RobotRenderer([meshes[n] for n in names], H, W, tile=CFG, device=d)
        e = SpaceExplorer(chain, r, names, score_batch=5, max_dist=None)
        prc.loss_fwd_compact_cuda.launches = 0
        out[d.type] = [a.cpu().numpy() for a in e._score(q, hyp, K, shared=shared)]
        launches = prc.loss_fwd_compact_cuda.launches
        if d.type == "cuda":
            assert launches == 3 * 4  # ⌈12 / 5⌉ batches × 4 hypotheses
            assert e.last_bin_states == (3 if shared else 12)
    (vk, fk, ok), (vp, fp, op) = out["cuda"], out["cpu"]
    assert np.array_equal(fk, fp) and not ok and not op
    assert np.abs(vp).max() > 1.0
    np.testing.assert_allclose(vk, vp, rtol=0, atol=1e-4 * np.abs(vp).max())


def test_unet_forward_and_training_step_cuda_matches_cpu(dev):
    """The segmenter's U-Net (cuDNN convolutions, TF32 off as every entry
    point sets it) on the card against the CPU: the forward's logits at
    3e-3 of their largest magnitude (cuDNN picks FFT and Winograd FP32
    algorithms, and GroupNorm divides each layer's rounding by its spread;
    chip_smoke.py holds the trained U-Net at 1280x720 to the same); one
    training step's loss at rtol 1e-5 and its logits within 5 % of how far
    the step moved them (Adam's first step is ±lr whatever a gradient's
    size, so weights whose gradient is near roundoff may step either way;
    tests/test_torch_segmentation.py)."""
    from easyhec_torch import resolve_device
    from easyhec_torch.models import segmentation as seg

    resolve_device(dev)
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 60, (4, 72, 96, 3)).astype(np.uint8)
    masks = np.zeros((4, 72, 96), np.float32)
    for i in range(4):
        rgb[i, 10 + 5 * i:50, 20:70] = 180
        masks[i, 10 + 5 * i:50, 20:70] = 1.0
    m0 = seg.UNet(16)
    seg._flax_init(m0, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in m0.state_dict().items()}

    def logits(st, d):
        m = seg.UNet(16)
        m.load_state_dict(st)
        m.to(d).eval()
        with torch.no_grad():
            x = torch.as_tensor(rgb, dtype=torch.float32, device=d) / 255.0
            return m(x).cpu().numpy()

    l_cpu, l_dev = logits(state, "cpu"), logits(state, dev)
    np.testing.assert_allclose(l_dev, l_cpu, rtol=0, atol=3e-3 * np.abs(l_cpu).max())
    out = {}
    for d in (dev, torch.device("cpu")):
        st, loss = seg.train_segmenter(rgb, masks, steps=1, base=16, init_params=state,
                                       device=d)
        out[d.type] = (logits({k: v.cpu() for k, v in st.items()}, "cpu"), loss)
    (a, la), (b, lb) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    moved = np.abs(b - l_cpu).max()
    assert moved > 1e-3 and np.abs(a - b).max() <= 0.05 * moved
