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
from pathlib import Path

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
from easyhec_torch.utils import cuda_graph

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]

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


# ---------------------------------------------------------------------------
# The binner's counting-sort kernels (ops/binning.py) against the plain
# version (render/binning.py::_bin_count_flat) on the same card tensors.
# ---------------------------------------------------------------------------

# name: (B, F, H, W, tile_h, tile_w, cap, ry, rx, big_k, suby,
#        bbox half-size mean, big share, big half-size (y, x)) and whether the
#        plain version flags an overflow in some frame
BIN_CASES = {
    # the explorer's scoring shape (960x540 of franka-1080p, budgets doubled)
    "explore": ((5, 21312, 540, 960, 16, 64, 4096, 21, 7, 10752, True, 4.0, 0.03, (100, 150)),
                False),
    # the calibration's rebin (xarm7-720p)
    "calib": ((10, 21312, 720, 1280, 16, 32, 1664, 8, 5, 3840, True, 2.0, 0.03, (40, 60)),
              False),
    # the global search's sweep batch: 60x80, the auto window (the whole 4x3
    # grid), no big class, no row classes; its tiles truncate at cap
    "search": ((64, 21312, 60, 80, 16, 32, 1664, 4, 3, 0, False, 0.5, 0.02, (10, 10)), True),
    # a config (5) band: 1920x540, 16x64 tiles
    "c5_band": ((40, 21312, 540, 1920, 16, 64, 1280, 7, 4, 3584, True, 3.0, 0.02, (30, 80)),
                False),
    "cap_over": ((3, 3000, 64, 96, 16, 32, 64, 3, 3, 300, True, 2.0, 0.05, (20, 30)), True),
    "rect_over": ((3, 3000, 256, 384, 16, 32, 1024, 2, 2, 0, True, 2.0, 0.05, (40, 60)), True),
    "big_over": ((3, 3000, 256, 384, 16, 32, 1024, 4, 3, 16, True, 2.0, 0.05, (20, 30)), True),
    # histograms past the kernels' shared memory (16320 and 16200 keys), so
    # they are counted and placed in passes over key ranges: 1920x1080 with
    # 16x32 tiles, row classes and big_k; 8x16 tiles, one class, one group
    "multi_pass": ((2, 21312, 1080, 1920, 16, 32, 1664, 8, 5, 7680, True, 3.0, 0.03, (40, 50)),
                   False),
    "multi_pass_dense": ((2, 3000, 1080, 1920, 8, 16, 256, 6, 5, 0, False, 1.5, 0.02, (6, 12)),
                         False),
}


def _bin_boxes(dev, B, F, H, W, th, tw, half, big_frac, big_half, seed=0):
    """Margin-dilated bboxes [B, F]: most on an arm-sized blob, the rest
    anywhere on and off the image, a share spanning many tiles, every
    seventh starting or ending exactly on a tile edge; valid 90 %; suby the
    centre row."""
    rng = np.random.default_rng(seed)
    near = rng.random((B, F)) < 0.7
    cx = np.where(near, rng.normal(0.5 * W, 0.08 * W, (B, F)),
                  rng.uniform(-0.05 * W, 1.05 * W, (B, F)))
    cy = np.where(near, rng.normal(0.5 * H, 0.12 * H, (B, F)),
                  rng.uniform(-0.05 * H, 1.05 * H, (B, F)))
    big = rng.random((B, F)) < big_frac
    hw = np.where(big, rng.uniform(0, big_half[1], (B, F)), rng.exponential(half, (B, F)))
    hh = np.where(big, rng.uniform(0, big_half[0], (B, F)), rng.exponential(half, (B, F)))
    lox, hix, loy, hiy = cx - hw, cx + hw, cy - hh, cy + hh
    edge = np.arange(F) % 7 == 0
    lox[:, edge] = np.floor(lox[:, edge] / tw) * tw
    hiy[:, edge] = np.ceil(hiy[:, edge] / th) * th
    valid = rng.random((B, F)) < 0.9
    boxes = [torch.from_numpy(a.astype(np.float32)).to(dev)
             for a in (lox, loy, hix, hiy, 0.5 * (loy + hiy))]
    return boxes[:4] + [torch.from_numpy(valid).to(dev), boxes[4]]


def _bin_args(dev, case):
    (B, F, H, W, th, tw, cap, ry, rx, big_k, sub, *box), _ = BIN_CASES[case]
    lox, loy, hix, hiy, valid, suby = _bin_boxes(dev, B, F, H, W, th, tw, *box)
    return (lox, loy, hix, hiy, valid, suby if sub else None, H, W, th, tw, cap, ry, rx, big_k)


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_count_kernels_match_plain(dev, case):
    """bin_count_cuda against _bin_count_flat on the same card tensors: idx,
    counts, q and overflow bit for bit, eagerly (outputs on memory the
    allocator last held garbage in), inside a captured graph and inside a
    CondGraph body, both replayed onto outputs scribbled over, and a body
    that is not taken leaves them alone. .launches counts each run, graph
    replays and taken branches too."""
    from easyhec_torch.ops.binning import bin_count_cuda
    from easyhec_torch.render.binning import _bin_count_flat
    from easyhec_torch.utils import cuda_graph

    args = _bin_args(dev, case)
    want = _bin_count_flat(*args)
    assert bool(want.overflow.any()) == BIN_CASES[case][1]
    assert int(want.counts.sum()) > 0

    def check(got, how):
        for name, w, g in zip(want._fields, want, got):
            assert torch.equal(w, g), f"{case}, {how}: {name} differs"

    def scribble(st):
        for w, g in zip(want, st):
            g.copy_(~w) if g.dtype == torch.bool else g.fill_(-7)

    junk = torch.full((2 * sum(t.numel() for t in want),), -7, dtype=torch.int32, device=dev)
    del junk
    n0 = bin_count_cuda.launches
    check(bin_count_cuda(*args), "eager")
    assert bin_count_cuda.launches == n0 + 1

    counters = cuda_graph.Counters.kernels()
    out = {}

    def run():
        out["st"] = bin_count_cuda(*args)

    cuda_graph.warm_up(run, counters, dev)
    n0 = bin_count_cuda.launches
    g = cuda_graph.Graph(run, counters)
    assert bin_count_cuda.launches == n0
    scribble(out["st"])
    g.replay()
    torch.cuda.synchronize()
    check(out["st"], "graph")
    assert bin_count_cuda.launches == n0 + 1

    flag = torch.ones((), dtype=torch.bool, device=dev)
    ticks = torch.zeros((), dtype=torch.int32, device=dev)
    run()  # the body's outputs exist before its capture, as _Scan's warm-up gives them
    cg = cuda_graph.CondGraph(flag, run, lambda: ticks.add_(1), counters)
    n0 = bin_count_cuda.launches
    scribble(out["st"])
    cg.replay()
    cg.taken(1)
    torch.cuda.synchronize()
    check(out["st"], "conditional body")
    assert bin_count_cuda.launches == n0 + 1
    flag.fill_(False)
    scribble(out["st"])
    cg.replay()
    torch.cuda.synchronize()
    assert int(ticks) == 2 and bool((out["st"][1] == -7).all())
    assert bin_count_cuda.launches == n0 + 1


def test_bin_count_on_the_card_runs_no_sort_or_scatter(dev):
    """render/binning.py::bin_count on CUDA tensors at the explorer's
    scoring shape: under the profiler, only the binner's four kernels run
    (no radix sort, no scatter or gather of PyTorch's), one launch
    counted."""
    from easyhec_torch.ops.binning import bin_count_cuda
    from easyhec_torch.render.binning import bin_count

    a = _bin_args(dev, "explore")
    kw = dict(zip(("H", "W", "tile_h", "tile_w", "cap", "ry", "rx", "big_k"), a[6:]))
    bin_count(*a[:6], **kw)  # loads the library outside the trace
    torch.cuda.synchronize()
    n0 = bin_count_cuda.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        bin_count(*a[:6], **kw)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
    assert bin_count_cuda.launches == n0 + 1
    assert {n for n in names if "bin_" in n and "_kernel" in n} and all(
        "bin_" in n for n in names if "Memcpy" not in n and "Memset" not in n), names


# ---------------------------------------------------------------------------
# The bin state's setup and compact pack kernels (ops/rebin.py) against the
# plain build (render/fused.py's _tri_setup_plain and _compact_pack_plain) on
# the same card tensors.
# ---------------------------------------------------------------------------

_REBIN_TILES = {  # the cells' tile configurations (hec_bench/configs)
    "franka": dict(tile_h=16, tile_w=64, margin=4.0, rect_y=21, rect_x=7),
    "xarm7": dict(tile_h=16, tile_w=32, margin=2.0, rect_y=8, rect_x=5),
    "rig": dict(tile_h=16, tile_w=64, margin=4.0, rect_y=5, rect_x=3),
}
# name: (tiles, B, H, W, f, rows above the band, capacity, bin_big_k,
#        compact_chunks, edits of the scene, TileConfig fields replaced)
COMPACT_CASES = {
    # the explorer's scoring shape (franka-1080p at 960x540, budgets doubled)
    "explore": ("franka", 5, 540, 960, 700.0, 0, 4096, 10752, 1104, (), {}),
    # the calibration's rebin (xarm7-720p)
    "calib": ("xarm7", 10, 720, 1280, 906.8, 0, 1664, 3840, 384, (), {}),
    # a rig band: the lower 540 rows of 1920x1080 (cy shifted), 40 frame-views
    "rig_band": ("rig", 40, 540, 1920, 1400.0, 540, 2176, 3840, 400, (), {}),
    "no_cull": ("xarm7", 4, 720, 1280, 906.8, 0, 1664, 3840, 384, (),
                {"cull_backfaces": False}),
    "no_subsort": ("xarm7", 4, 720, 1280, 906.8, 0, 1664, 3840, 384, (),
                   {"bin_subsort_rows": False}),
    # frame 0's fore link 1 cm in front of the camera: faces cross the near plane
    "behind_near": ("xarm7", 3, 720, 1280, 906.8, 0, 4096, 3840, 768, ("near",), {}),
    # faces with a repeated corner (zero area)
    "degenerate": ("xarm7", 3, 720, 1280, 906.8, 0, 1664, 3840, 384, ("degenerate",), {}),
    # frame 1's links 5 m behind the camera: no triangle, ncu 0
    "empty_frame": ("xarm7", 3, 720, 1280, 906.8, 0, 1664, 3840, 384, ("empty",), {}),
    # a chunk budget below the used chunks: overflow, no padding
    "ncu_over": ("xarm7", 3, 720, 1280, 906.8, 0, 1664, 3840, 6, (), {}),
    # the explorer's budgets after three doublings
    "escalated": ("franka", 5, 540, 960, 700.0, 0, 32768, 86016, 8832, (), {}),
    # every frame's links 5 m behind the camera: all frames pad on the last tile
    "all_empty": ("xarm7", 2, 720, 1280, 906.8, 0, 1664, 3840, 384, ("all_empty",), {}),
    # a one-tile image: the whole arm in tile 0
    "one_tile": ("franka", 2, 16, 64, 20.0, 0, 32768, 10752, 256, (), {}),
    # two tiles both past a capacity of two chunks: full tiles, the last one
    # continued by the padding; the binner's overflow
    "full_tiles": ("franka", 2, 16, 128, 20.0, 0, 256, 10752, 8, (), {}),
    # the rig band with the boundary-prefix backward map (bwd_chunks > 0),
    # which reads the pack's chunk layout
    "bwd_map": ("rig", 40, 540, 1920, 1400.0, 540, 2176, 3840, 400, (), {"bwd_chunks": 400}),
}
_ARM = {}


def _arm_meshes():
    """The benchmark's arm: the mini arm subdivided to 8 mm edges (21,312
    triangles), with its chain."""
    if not _ARM:
        from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
        from easyhec_torch.robot.mesh import subdivide_to_max_edge

        model = parse_urdf(ROOT / "assets" / "mini_arm.urdf")
        names = ["base", "upper", "fore"]
        meshes = load_link_meshes(model, link_names=names)
        _ARM.update(chain=build_chain(model), names=names,
                    meshes=[subdivide_to_max_edge(meshes[n], 0.008) for n in names])
    return _ARM["chain"], _ARM["names"], _ARM["meshes"]


def _compact_case(dev, case):
    """(renderer, Tc [4, 4], lp [B, L, 4, 4], K, nc) of a COMPACT_CASES case:
    the mini arm at 0.4 x its joint limits, seen from (1.0, 0.7, 0.8)."""
    from easyhec_torch.geometry import camera

    tiles, B, Hc, Wc, f, band, cap, big_k, nc, edits, repl = COMPACT_CASES[case]
    chain, names, meshes = _arm_meshes()
    tile = TileConfig(capacity=cap, binner="count", fused=True, cull_backfaces=True,
                      bwd_band_only=True, bin_big_k=big_k, bin_subsort_rows=True,
                      compact_chunks=nc, **_REBIN_TILES[tiles])._replace(**repl)
    r = RobotRenderer(meshes, Hc, Wc, tile=tile, device=dev)
    rng = np.random.default_rng(7)
    lim = chain.joint_limits * 0.4
    qs = rng.uniform(lim[:, 0], lim[:, 1], (B, chain.n_dof)).astype(np.float32)
    lp = chain.fk(torch.from_numpy(qs).to(dev))[:, [chain.link_index(n) for n in names]]
    K = torch.tensor([[f, 0, Wc / 2], [0, f, (Hc + band) / 2 - band], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    Tc = se3.inverse(camera.look_at(torch.tensor([1.0, 0.7, 0.8], device=dev),
                                    torch.tensor([0.0, 0.0, 0.3], device=dev), up))
    lp = lp.clone()
    if "near" in edits:
        shift = torch.eye(4, device=dev)
        shift[2, 3] = 0.01
        lp[0, 2] = se3.inverse(Tc) @ shift
    if "empty" in edits or "all_empty" in edits:
        shift = torch.eye(4, device=dev)
        shift[2, 3] = -5.0
        lp[slice(None) if "all_empty" in edits else 1] = se3.inverse(Tc) @ shift
    if "degenerate" in edits:
        r.corners_rest[2, :, ::97] = r.corners_rest[1, :, ::97]
    return r, Tc, lp, K, nc


def _plain_compact(monkeypatch, r, Tc, lp, K, nc):
    """build_compact_state through the plain setup and pack on the same card
    tensors (the binner's kernels equal its plain version bit for bit)."""
    import easyhec_torch.render.fused as rf

    with monkeypatch.context() as m:
        m.setattr(rf, "dispatch", lambda cuda_fn, plain_fn, *a: plain_fn(*a))
        return (build_compact_state(r, Tc, lp, K, nc=nc),
                rf._fused_bins_and_fields(r, Tc, lp, K))


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_state_kernels_match_plain(dev, case, monkeypatch):
    """build_compact_state on the card (one setup kernel, the binner, the
    pack's two kernels) against the plain PyTorch build on the same inputs:
    every CompactState field equal bit for bit (rec, nlive, ctmap, ncu,
    counts, overflow and the backward's chunk map: the identity, or with
    bwd_chunks the boundary-prefix map read off the pack's layout), and the
    shared stage
    the dense route takes too (the bins and the field table); one launch of
    each new wrapper per bin state."""
    import easyhec_torch.render.fused as rf
    from easyhec_torch.ops.rebin import compact_pack_cuda, tri_setup_cuda

    r, Tc, lp, K, nc = _compact_case(dev, case)
    want, (wbins, wf, _) = _plain_compact(monkeypatch, r, Tc, lp, K, nc)
    n0 = (tri_setup_cuda.launches, compact_pack_cuda.launches)
    got = build_compact_state(r, Tc, lp, K, nc=nc)
    assert (tri_setup_cuda.launches, compact_pack_cuda.launches) == (n0[0] + 1, n0[1] + 1)
    gbins, gf, _ = rf._fused_bins_and_fields(r, Tc, lp, K)
    torch.cuda.synchronize()
    for name, w, g in zip(want._fields, want, got):
        assert w.dtype == g.dtype and torch.equal(w, g), f"{case}: {name} differs"
    for name, w, g in zip(wbins._fields, wbins, gbins):
        assert torch.equal(w, g), f"{case}: bins' {name} differs"
    assert torch.equal(wf, gf), f"{case}: the field table differs"
    ncu, counts, valid = got.ncu.cpu(), got.counts.cpu(), gf[:, 3, :-1].cpu()
    assert (int(counts.sum()) > 0) == (case != "all_empty")
    if case == "all_empty":
        T = counts.shape[1]
        assert not bool(got.overflow) and not bool(ncu.any()) and not bool(got.nlive.any())
        assert bool((got.ctmap == T - 1).all())
    if case == "one_tile":
        assert counts.shape[1] == 1 and not bool(got.overflow)
    if case == "full_tiles":
        assert bool(got.overflow) and bool((counts == r.tile.capacity).all())
        assert bool((got.ctmap.cpu()[:, int(ncu.max()):] == counts.shape[1] - 1).all())
    if case == "bwd_map":
        assert got.bwd_nlive.shape == (counts.shape[0], 400) and bool(got.bwd_nlive.any())
    if case == "empty_frame":
        assert int(ncu[1]) == 0 and int(counts[1].sum()) == 0 and not bool(valid[1].any())
    if case == "ncu_over":
        assert bool(got.overflow) and int(ncu.max()) > nc
    elif case != "behind_near":
        assert int(ncu.max()) <= nc
    if case == "behind_near":  # the fore link: some faces kept, some culled
        fore = (r.face_link_id == 2).cpu()
        assert bool(valid[0, fore].any()) and not bool(valid[0, fore].all())
    if case == "degenerate":
        assert not bool(valid[:, ::97].any())


def test_bin_state_on_the_card_runs_seven_kernels(dev):
    """RobotRenderer.bin_state at the explorer's scoring shape on the card:
    under the profiler, the setup kernel, the binner's four and the pack's
    two run, beside at most three kernels of PyTorch's for the camera-from-
    link product; each new wrapper counts one launch."""
    from easyhec_torch.ops.rebin import compact_pack_cuda, tri_setup_cuda

    r, Tc, lp, K, _ = _compact_case(dev, "explore")
    r.bin_state(Tc, lp, K)  # loads the libraries outside the trace
    torch.cuda.synchronize()
    n0 = (tri_setup_cuda.launches, compact_pack_cuda.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        r.bin_state(Tc, lp, K)
        torch.cuda.synchronize()
    # the trace's device events as hec_bench/harness.py reads them, one per launch
    kern = [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA" and not e.is_user_annotation()
            and "Memcpy" not in e.name() and "Memset" not in e.name()]
    ours = ("tri_setup_kernel", "compact_scan_kernel", "compact_gather_kernel", "bin_prep_kernel",
            "bin_hist_kernel", "bin_scan_kernel", "bin_place_kernel")
    assert sorted(k for k in ours for n in kern if k in n) == sorted(ours), kern
    others = [n for n in kern if not any(k in n for k in ours)]
    assert len(others) <= 3, others
    assert (tri_setup_cuda.launches, compact_pack_cuda.launches) == (n0[0] + 1, n0[1] + 1)


# ---------------------------------------------------------------------------
# The calibration step's kernels (ops/step.py) against their plain twins
# ---------------------------------------------------------------------------


def _step_case(dev, case):
    """(renderer, bin state, _KernelStep with the drift probes, pose twist) of
    a COMPACT_CASES case: the reference its own silhouette shifted 3 px right,
    so loss and gradient are real; the frames weighted 1/B."""
    from easyhec_torch.models import calib
    from easyhec_torch.render.fused import silhouette_compact

    r, Tc, lp, K, _ = _compact_case(dev, case)
    st = r.bin_state(Tc, lp, K)
    target = torch.roll((silhouette_compact(r, Tc, K, st) > 0.5).float(), 3, dims=-1)
    B = lp.shape[0]
    k = calib._KernelStep(r, lp, K, calib.tile_masks(target, r), 1.0,
                          torch.full((B,), 1.0 / B, device=dev))
    k.probes = calib.drift_probe_points(r, lp).contiguous()
    return r, st, k, se3.log(Tc)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


STEP_OPTIONS = {"adam": dict(name="adam"), "sgd": dict(name="sgd"),
                "clip": dict(name="adam", grad_clip=1e-3, grad_clip_value=5e-4),
                "warmup_cosine": dict(name="adam", scheduler="warmup_cosine", warmup_steps=3)}


@pytest.mark.parametrize("case", ["calib", "rig_band"])
def test_step_kernels_match_twins(dev, case):
    """The three step kernels against their plain twins on the same card
    tensors, at the calib cell's shape (10 frames of 1280x720, 16x32 tiles)
    and a rig band's (40 frame-views of 1920x540, 16x64): the head's pose
    and camera rows to 1e-6 of their largest magnitude, its Jacobian to
    1e-5, its probe pixels to 1e-6; the grad on K2f's and K2b's real
    partials, its loss to rtol 1e-5 and its gradient to 1e-4 of the largest
    component (another summation order), a second launch bit for bit and
    the ticket back at 0; five updates under adam, sgd, both clips and
    warmup_cosine with the drift test: pose, leaves and history to 1e-6,
    losses, step index and flags equal. One launch of each wrapper a call."""
    from easyhec_torch.ops import step
    from easyhec_torch.render.fused import loss_parts
    from easyhec_torch.solver.optim import make_optimizer

    r, st, k, dof = _step_case(dev, case)
    B, P = k.w.shape[0], k.probes.shape[0]
    d = (dof + 0.002).contiguous()
    bufs = {}
    for side, fn in (("kernel", step.step_head_cuda), ("twin", step.step_head_plain)):
        b = dict(Tc=torch.zeros(4, 4, device=dev), cam=torch.zeros(B, 16, device=dev),
                 jac=torch.zeros(12, 6, device=dev), pix=torch.zeros(P, 2, device=dev))
        n0 = step.step_head_cuda.launches
        fn(d, k.K, b["Tc"], b["cam"], b["jac"], k.probes, b["pix"])
        assert step.step_head_cuda.launches == n0 + (side == "kernel")
        bufs[side] = b
    torch.cuda.synchronize()
    got, want = bufs["kernel"], bufs["twin"]
    assert _rel(got["Tc"], want["Tc"]) < 1e-6 and _rel(got["cam"], want["cam"]) < 1e-6
    assert _rel(got["jac"], want["jac"]) < 1e-5 and _rel(got["pix"], want["pix"]) < 1e-6

    lparts, parts, counts = loss_parts(r, want["cam"], st, k.ref_tiles, k.w)
    args = (parts, lparts, counts, k.ref_sq, k.w, want["jac"])
    gl, gl2, glp = (torch.zeros(7, device=dev) for _ in range(3))
    n0 = step.step_grad_cuda.launches
    step.step_grad_cuda(*args, gl, k.work)
    step.step_grad_cuda(*args, gl2, k.work)
    step.step_grad_plain(*args, glp)
    torch.cuda.synchronize()
    assert step.step_grad_cuda.launches == n0 + 2
    assert torch.equal(gl, gl2) and int(k.work[1]) == 0
    assert abs(float(gl[0] - glp[0])) <= 1e-5 * abs(float(glp[0])) and float(glp[0]) > 0
    assert _rel(gl[1:], glp[1:]) < 1e-4 and float(glp[1:].abs().max()) > 0

    for option, kw in STEP_OPTIONS.items():
        kw = dict(kw)
        opt = make_optimizer(kw.pop("name"), max_lr=3e-3, total_steps=100, **kw)
        runs = {}
        for side, fn in (("kernel", step.step_update_cuda), ("twin", step.step_update_plain)):
            u = dict(dof=d.clone(), leaves=[t.clone() for t in opt.leaves(opt.init(d))],
                     losses=torch.zeros(8, device=dev), history=torch.zeros(8, 6, device=dev),
                     idx=torch.zeros(1, dtype=torch.int64, device=dev),
                     need=torch.zeros((), dtype=torch.bool, device=dev),
                     inner=torch.ones((), dtype=torch.int64, device=dev))
            flags = []
            for i in range(5):
                fn(glp * (1.0 + 0.2 * i), 2.0, opt, u["leaves"], u["dof"], u["losses"],
                   u["history"], u["idx"], u["need"], u["inner"],
                   (k.probes, k.K, got["pix"], 1.0))
                flags.append(bool(u["need"]))
            runs[side] = u, flags
        (uk, fk), (up, fp) = runs["kernel"], runs["twin"]
        assert fk == fp and int(uk["idx"]) == int(up["idx"]) == 5, option
        assert torch.equal(uk["losses"], up["losses"]), option
        assert _rel(uk["dof"], up["dof"]) < 1e-6 and _rel(uk["history"], up["history"]) < 1e-6
        for a, b in zip(uk["leaves"], up["leaves"]):
            assert a.dtype == b.dtype and _rel(a.double(), b.double()) < 1e-6, option


def test_graphed_step_runs_few_kernels(dev, monkeypatch):
    """One replay of calibrate's step graph on the kernel route with the
    rebin flag clear (the conditional body skipped), under the profiler: at
    most 10 kernels and memsets on the card (the flag's kernel, the head,
    the fused forward's two output fills, K2f, K2b, the grad and the
    update), against ~340 small kernels of the autograd step."""
    from easyhec_torch.models import calib

    _graphs(True, monkeypatch)
    r, _, t = _scene(dev, True)
    opt = calib.make_optimizer("adam", max_lr=3e-3, total_steps=100)
    d = t["xi"] + 0.01
    scan = calib._chunk_scan(d, opt.init(d), opt, t["lp"], t["K"], t["target"],
                             calib.tile_masks(t["target"], r), r, 50, 1.0, 0.0, 0)
    assert scan.graph is not None and scan.kernel is not None
    scan.run(50)
    scan.bufs["need"].fill_(False)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        scan.graph.replay()
        torch.cuda.synchronize()
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if e.device_type().name == "CUDA" and not e.is_user_annotation()]
    for name in ("step_head_kernel", "step_grad_kernel", "step_update_kernel",
                 "loss_fwd_compact_kernel", "loss_bwd_compact_kernel"):
        assert sum(name in o for o in ops) == 1, (name, ops)
    assert len(ops) <= 10, ops


@pytest.mark.parametrize("shared", [False, True], ids=["exact", "shared"])
def test_explorer_score_cuda_matches_cpu_and_counts_launches(dev, shared):
    """SpaceExplorer._score (one K3 launch per batch and hypothesis, one
    binner launch per bin state) on the card against the plain path on the
    CPU: the variance to 1e-4 of its largest value, feasibility equal."""
    from pathlib import Path

    from easyhec_torch.models.explorer import SpaceExplorer, draw_hypotheses_and_candidates
    from easyhec_torch.ops.binning import bin_count_cuda
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
        prc.loss_fwd_compact_cuda.launches = bin_count_cuda.launches = 0
        out[d.type] = [a.cpu().numpy() for a in e._score(q, hyp, K, shared=shared)]
        launches = prc.loss_fwd_compact_cuda.launches
        if d.type == "cuda":
            assert launches == 3 * 4  # ⌈12 / 5⌉ batches × 4 hypotheses
            assert e.last_bin_states == (3 if shared else 12)
        assert bin_count_cuda.launches == (e.last_bin_states if d.type == "cuda" else 0)
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


def test_band_renders_match_full_rows(dev):
    """A band renderer (H/2 rows, the principal point shifted by
    parallel.sharding._band_K) through K4f draws the full render's rows of
    that band: the sharded path's premise, on the card."""
    from easyhec_torch.parallel.sharding import _band_K

    r, _, t = _dense_scene(dev, True)
    bh = HD // 2
    band = RobotRenderer(r.meshes, bh, WD, tile=r.tile, device=dev)
    with torch.no_grad():
        full = r.silhouette(se3.exp(t["xi"]), t["lp"], t["K"])
        for ti in range(2):
            part = band.silhouette(se3.exp(t["xi"]), t["lp"], _band_K(t["K"], ti * bh))
            np.testing.assert_allclose(part.cpu(), full[:, ti * bh:(ti + 1) * bh].cpu(),
                                       atol=1e-4)


def test_sharded_calibrate_one_nccl_rank_matches_calibrate(dev, tmp_path):
    """An NCCL process group of one rank and the (1, 1) DeviceMesh: the
    sharded optimizer runs the compact kernels once per step and tracks the
    one-device calibrate (JAX's tolerances, tests/test_sharding.py)."""
    import torch.distributed as dist

    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.parallel import init_distributed, make_mesh, sharded_calibrate

    r, _, t = _scene(dev, True)
    init_distributed(f"file://{tmp_path / 'rdv'}", num_processes=1, process_id=0,
                     backend="nccl")
    try:
        init = (t["xi"] + 0.01).cpu().numpy()
        ref = calibrate(init, r, t["lp"], t["K"], t["target"], num_steps=30, rebin_every=0)
        f0, b0 = prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches
        dof, losses, _ = sharded_calibrate(init, r, make_mesh(1, 1), t["lp"], t["K"],
                                           t["target"], num_steps=30, rebin_every=0)
        torch.cuda.synchronize()
        assert prc.loss_fwd_compact_cuda.launches == f0 + 30
        assert prc.loss_bwd_compact_cuda.launches == b0 + 30
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(losses.cpu().numpy()[:10], ref.losses[:10], rtol=3e-3,
                               atol=1e-3)
    np.testing.assert_allclose(dof.cpu().numpy(), ref.dof, atol=5e-3)


# ---------------------------------------------------------------------------
# The captured CUDA graphs (models.calib._Scan, SpaceExplorer._score) against
# the same functions run eagerly on the card: bit for bit (the same kernels
# on the same inputs in the same order), with the launch counters counting
# the replays.
# ---------------------------------------------------------------------------


def _graphs(graphed: bool, monkeypatch) -> None:
    """utils.cuda_graph.captures, the one place that says whether work on
    the card runs as CUDA graphs, as it is (graphed) or refusing (eager)."""
    monkeypatch.setattr(cuda_graph, "captures",
                        CAPTURES if graphed else lambda device: False)


CAPTURES = cuda_graph.captures


def _count_replays(monkeypatch):
    """Count utils.cuda_graph.Graph and CondGraph replays into the returned
    list."""
    from easyhec_torch.utils import cuda_graph

    replays = []
    for cls in (cuda_graph.Graph, cuda_graph.CondGraph):
        def replay(self, real=cls.replay):
            replays.append(self)
            real(self)

        monkeypatch.setattr(cls, "replay", replay)
    return replays


def test_conditional_node_runs_its_body_only_when_set(dev):
    """utils.cuda_graph.CondGraph (ops/csrc/graph_cond.cu's IF node): over
    replays with the flag set and unset, in an order the device flips
    itself, the body's effect and the tail's equal the eager runs of the
    same functions bit for bit; a body's allocation keeps its value across
    replays that skip it."""
    from easyhec_torch.utils import cuda_graph

    def state():
        return dict(flag=torch.ones((), dtype=torch.bool, device=dev),
                    x=torch.zeros(5, device=dev), y=torch.zeros(5, device=dev), out=[None])

    def parts(s):
        def body():
            s["out"][0] = s["x"] * 2 + 1  # allocated inside the body
            s["x"].add_(1.5)

        def tail():
            s["y"].add_(s["out"][0] + s["x"])
            torch.logical_not(s["flag"], out=s["flag"])  # the device flips the flag

        return body, tail

    def eager_turn(s):
        body, tail = parts(s)
        if bool(s["flag"]):
            body()
        tail()

    eager, graphed = state(), state()
    eager_turn(eager)  # the capture needs the body's output once, as _Scan's warmup gives it
    eager_turn(graphed)
    g = cuda_graph.CondGraph(graphed["flag"], *parts(graphed), cuda_graph.Counters([]))
    assert g.body_moved == [] and g.moved == []
    eager["flag"].fill_(True)  # the graph's body output exists once its body ran
    graphed["flag"].fill_(True)
    for _ in range(7):
        eager_turn(eager)
        g.replay()
    torch.cuda.synchronize()
    for k in ("x", "y", "flag"):
        assert torch.equal(eager[k], graphed[k]), k
    assert torch.equal(eager["out"][0], graphed["out"][0])


@pytest.mark.parametrize("rebin_every", [0, 3], ids=["adaptive", "every3"])
@pytest.mark.parametrize("route", ["compact", "compact_k3", "dense", "unfused"])
def test_graphed_calibrate_matches_eager(dev, route, rebin_every, monkeypatch):
    """calibrate's loop (_calibrate_scan) graphed and eager (_graphs) on the card,
    60 steps (chunks of 50 and 10), with adaptive rebinning or windows of 3
    (the last window of a chunk runs to its end: 51 and 12 steps): losses,
    history, pose, rebins and overflow equal bit for bit; the route's loss
    kernels launch once per step run in both, and on compact_k3 (bwd_chunks
    > 0) K3 once more per rebin, inside the conditional rebin; the graphed
    run replays its one step graph once per step, the eager run none. On the
    fused routes the step runs on ops/step.py's kernels (one grad and one
    update a step, the head once more a rebin) and kernel_steps counts the
    steps; the unfused route launches none of them."""
    from easyhec_torch.models import calib
    from easyhec_torch.ops import step
    from easyhec_torch.ops import tile_raster as tr_
    from easyhec_torch.ops.binning import bin_count_cuda
    from easyhec_torch.ops.rebin import compact_pack_cuda, tri_setup_cuda

    if route.startswith("compact"):
        r, _, t = _scene(dev, True)
        kernels = (prc.loss_fwd_compact_cuda, prc.loss_bwd_compact_cuda)
        if route == "compact_k3":
            r = RobotRenderer(r.meshes, H, W, tile=r.tile._replace(bwd_chunks=16), device=dev)
    else:
        r, _, t = _dense_scene(dev, True)
        kernels = (pr.loss_fwd_cuda, pr.loss_bwd_cuda)
        if route == "unfused":
            r = RobotRenderer(r.meshes, HD, WD, tile=UNFUSED, device=dev)
            kernels = (tr_.tile_fwd_cuda, tr_.tile_bwd_counted_cuda)
    replays = _count_replays(monkeypatch)
    builds = (tri_setup_cuda, compact_pack_cuda, bin_count_cuda)
    stepk = (step.step_head_cuda, step.step_grad_cuda, step.step_update_cuda)
    steps, out, launches, n_replays, n_builds, n_step = 60, {}, {}, {}, {}, {}
    for graphed in (True, False):
        _graphs(graphed, monkeypatch)
        for k in kernels + builds + stepk:
            k.launches = 0
        replays.clear()
        counts = {}
        out[graphed] = calib._calibrate_scan(
            t["xi"] + 0.01, t["lp"], t["K"], t["target"], r, steps, 3e-3, "adam",
            "constant", 0.0, 1.0, rebin_every=rebin_every, on_overflow="warn", counts=counts)
        torch.cuda.synchronize()
        launches[graphed] = [k.launches for k in kernels]
        n_builds[graphed] = [k.launches for k in builds]
        n_step[graphed] = [k.launches for k in stepk] + [counts["kernel_steps"]]
        n_replays[graphed] = len(replays)
    (dg, lg, hg, ovg, rbg), (de, le, he, ove, rbe) = out[True], out[False]
    assert torch.equal(lg, le) and torch.equal(hg, he) and torch.equal(dg, de)
    assert (ovg, rbg) == (ove, rbe) and lg.shape == (steps,)
    run = steps if rebin_every == 0 else 51 + 12
    assert rbg >= 2 if rebin_every == 0 else rbg == 17 + 4
    k3 = rbg if route == "compact_k3" else 0
    assert launches[True] == launches[False] == [run + k3, run]
    assert n_replays == {True: run, False: 0}
    # one setup a bin state on the fused routes, one pack on the compact ones
    want = [rbg if route != "unfused" else 0, rbg if route.startswith("compact") else 0, rbg]
    assert n_builds[True] == n_builds[False] == want
    # the fused routes' step kernels: the head once a step and once a rebin
    # (the rebin's pose), the grad and the update once a step; kernel_steps
    # the steps run; the unfused route keeps the autograd step
    want = [run + rbg, run, run, run] if route != "unfused" else [0, 0, 0, 0]
    assert n_step[True] == n_step[False] == want


def test_graphed_chunk_issues_no_sync(dev, monkeypatch):
    """A graphed chunk is queued with no host read: its replays run clean
    under torch.cuda.set_sync_debug_mode("error"), and only the read after
    the chunk (the overflow flag and the rebin count) synchronizes; two
    chunks on one scan give the trace of the eager runner (_graphs) bit for
    bit."""
    from easyhec_torch.models import calib

    r, _, t = _scene(dev, True)
    out = {}
    for graphed in (True, False):
        _graphs(graphed, monkeypatch)
        opt = calib.make_optimizer("adam", max_lr=3e-3, total_steps=100)
        d = t["xi"] + 0.01
        scan = calib._chunk_scan(d, opt.init(d), opt, t["lp"], t["K"], t["target"],
                                 calib.tile_masks(t["target"], r), r, 50, 1.0, 0.0, 0)
        assert (scan.graph is not None) == graphed
        torch.cuda.synchronize()
        out[graphed] = []
        for _ in range(2):
            if graphed:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    scan.queue(50)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                scan.queue(50)
            b = scan.bufs
            out[graphed].append((b["losses"].clone(), b["history"].clone(), int(b["nrb"])))
    assert all(torch.equal(a, b) and torch.equal(h, i) and n == m >= 1
               for (a, h, n), (b, i, m) in zip(out[True], out[False]))


def test_graphed_sharded_calibrate_matches_eager(dev, tmp_path, monkeypatch):
    """sharded_calibrate on one NCCL rank and the (1, 1) mesh, graphed (one
    scan for the call, its step one CUDA graph) and eager (_graphs): losses,
    history and pose equal bit for bit over 60
    steps in chunks of 50 and 10, one replay and one compact kernel pair per
    step, and the kernel route's step kernels (one grad and one update a
    step, the head once more a rebin; shard.call's kernel_steps 60). Then
    chip_smoke.nccl_capture_check: one NCCL all_reduce
    (premultiplied by 2, so a replay shows) captured in a graph and replayed
    three times, since at world 1 _all_reduce issues no collective."""
    import torch.distributed as dist

    from easyhec_torch.parallel import init_distributed, make_mesh, sharded_calibrate

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    from easyhec_torch.ops import step
    from easyhec_torch.utils import profiling

    r, _, t = _scene(dev, True)
    init_distributed(f"file://{tmp_path / 'rdv'}", num_processes=1, process_id=0,
                     backend="nccl")
    replays = _count_replays(monkeypatch)
    stepk = (step.step_head_cuda, step.step_grad_cuda, step.step_update_cuda)
    out, counts, n_step = {}, {}, {}
    try:
        init = (t["xi"] + 0.01).cpu().numpy()
        for graphed in (True, False):
            _graphs(graphed, monkeypatch)
            for k in (prc.loss_fwd_compact_cuda, prc.loss_bwd_compact_cuda) + stepk:
                k.launches = 0
            replays.clear()
            out[graphed] = sharded_calibrate(init, r, make_mesh(1, 1), t["lp"], t["K"],
                                             t["target"], num_steps=60, rebin_every=0)
            torch.cuda.synchronize()
            counts[graphed] = (prc.loss_fwd_compact_cuda.launches,
                               prc.loss_bwd_compact_cuda.launches, len(replays))
            call = [sp for sp in profiling.spans() if sp.name == "shard.call"][-1]
            n_step[graphed] = ([k.launches for k in stepk], call.counts["kernel_steps"],
                               call.counts["own_rebins"])
        chip_smoke.nccl_capture_check()
    finally:
        dist.destroy_process_group()
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    assert counts == {True: (60, 60, 60), False: (60, 60, 0)}
    for launched, kernel_steps, rebins in n_step.values():
        assert launched == [60 + rebins, 60, 60] and kernel_steps == 60


NCCL_WORKER = r'''
import pickle, sys
import numpy as np, torch
sys.path[:0] = [{root!r}, {tests!r}]
rank, rdv, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(rank)
torch.backends.cuda.matmul.allow_tf32 = False
import test_torch_cuda as T
from easyhec_torch.ops import pose_raster_compact as prc
from easyhec_torch.ops import step
from easyhec_torch.parallel import init_distributed, make_mesh, sharded_calibrate
from easyhec_torch.render import RobotRenderer
from easyhec_torch.utils import cuda_graph, profiling
init_distributed(rdv, num_processes=4, process_id=rank, backend="nccl")
stepk = (step.step_head_cuda, step.step_grad_cuda, step.step_update_cuda)
dev = torch.device("cuda", rank)
r, _, t = T._scene(dev, True, B=4)
band = RobotRenderer(r.meshes, T.H // 2, T.W, tile=r.tile, device=dev)
mesh = make_mesh(2, 2)
captures, replays = cuda_graph.captures, []
real_replay = cuda_graph.CondGraph.replay
def replay(self):
    replays.append(1)
    real_replay(self)
cuda_graph.CondGraph.replay = replay
init = (t["xi"] + 0.01).cpu().numpy()
out = dict(rank=rank, backend=torch.distributed.get_backend())
for name, kw in {{"adaptive": dict(rebin_every=0),
                 "robust": dict(rebin_every=5, robust_delta=0.2, grad_clip=1.0)}}.items():
    for graphed in (True, False):
        cuda_graph.captures = captures if graphed else (lambda device: False)
        for k in (prc.loss_fwd_compact_cuda, prc.loss_bwd_compact_cuda) + stepk:
            k.launches = 0
        replays.clear()
        res = sharded_calibrate(init, band, mesh, t["lp"], t["K"], t["target"], num_steps=60,
                                max_lr=3e-3, **kw)
        torch.cuda.synchronize()
        out[name, graphed] = [x.cpu().numpy() for x in res]
        out["counts", name, graphed] = (prc.loss_bwd_compact_cuda.launches, len(replays))
        call = [sp for sp in profiling.spans() if sp.name == "shard.call"][-1]
        out["steps", name, graphed] = ([k.launches for k in stepk], call.counts["kernel_steps"],
                                       call.counts["own_rebins"])
torch.distributed.destroy_process_group()
open(d + f"/out{{rank}}.pkl", "wb").write(pickle.dumps(out))
print("WORKER_OK", rank)
'''


def test_graphed_sharded_calibrate_matches_eager_on_four_nccl_ranks(dev, tmp_path):
    """sharded_calibrate on 4 NCCL ranks, one per card, as a 2x2 (data x
    tile) mesh of the 4-frame scene's two 32-row bands: graphed (the step's
    collectives captured: the gradient's all-reduce inside autograd and,
    with robust_delta > 0, the tile group's all-reduce of the per-frame
    losses) against eager (utils.cuda_graph.captures patched to refuse), 60 steps,
    adaptive and every 5 with robust_delta and grad_clip. On every rank the
    graphed losses, history and pose equal the eager ones bit for bit, and
    the ranks agree bit for bit; one step-graph replay and one backward
    kernel per step on each rank. The adaptive run takes the kernel route
    (its combine the all-reduce of the grad kernel's [loss, g] in place:
    one grad and one update kernel a step, the head once more a rebin,
    kernel_steps 60), the Huber run autograd's (none)."""
    import os
    import pickle
    import subprocess
    import sys

    from easyhec_torch.ops import _build

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (one NCCL rank per card)")
    _build.build_all()  # the ranks load the libraries built here
    script = tmp_path / "worker.py"
    script.write_text(NCCL_WORKER.format(root=str(ROOT), tests=str(ROOT / "tests")))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), f"file://{tmp_path / 'rdv'}", str(tmp_path)],
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=str(ROOT)) for rank in range(4)]
    logs = []
    try:
        logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:  # a hung rank never outlives the test
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {rank}" in log, \
            f"rank {rank} failed:\n{log[-4000:]}"
    outs = [pickle.loads((tmp_path / f"out{rank}.pkl").read_bytes()) for rank in range(4)]
    for o in outs:
        assert o["backend"] == "nccl"
        for name in ("adaptive", "robust"):
            for a, b, c in zip(o[name, True], o[name, False], outs[0][name, True]):
                assert np.array_equal(a, b) and np.array_equal(a, c), (o["rank"], name)
            assert o["counts", name, True] == (60, 60) and o["counts", name, False] == (60, 0)
            for graphed in (True, False):  # the kernel route adaptive, autograd's with Huber
                launched, kernel_steps, rebins = o["steps", name, graphed]
                if name == "adaptive":
                    assert launched == [60 + rebins, 60, 60] and kernel_steps == 60
                else:
                    assert launched == [0, 0, 0] and kernel_steps == 0


@pytest.mark.parametrize("route", ["compact", "counted"])
@pytest.mark.parametrize("shared", [False, True], ids=["exact", "shared"])
def test_graphed_score_matches_eager(dev, shared, route, monkeypatch):
    """SpaceExplorer._score graphed (one graph per call, replayed per batch
    of 5 candidates) and eager (_graphs) on the card, 12 candidates × 4 hypotheses:
    variance, feasibility and overflow equal bit for bit, the same K3 (or
    K5f) launches and bin states; the graphed call replays its graph once
    per batch."""
    from pathlib import Path

    from easyhec_torch.models.explorer import SpaceExplorer, draw_hypotheses_and_candidates
    from easyhec_torch.ops import tile_raster as tr_
    from easyhec_torch.ops.rebin import compact_pack_cuda, tri_setup_cuda
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
    tile = CFG if route == "compact" else UNFUSED
    kernel = prc.loss_fwd_compact_cuda if route == "compact" else tr_.tile_fwd_cuda
    r = RobotRenderer([meshes[n] for n in names], H, W, tile=tile, device=dev)
    e = SpaceExplorer(chain, r, names, score_batch=5, max_dist=None)
    replays = _count_replays(monkeypatch)
    out, counts = {}, {}
    for graphed in (True, False):
        _graphs(graphed, monkeypatch)
        kernel.launches = tri_setup_cuda.launches = compact_pack_cuda.launches = 0
        replays.clear()
        out[graphed] = e._score(q, hyp, K, shared=shared)
        torch.cuda.synchronize()
        counts[graphed] = (kernel.launches, e.last_bin_states, len(replays),
                           int(e._max_load), tri_setup_cuda.launches,
                           compact_pack_cuda.launches)
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    assert counts[True][:2] == counts[False][:2] == (3 * 4, 3 if shared else 12)
    assert counts[True][2] == 3 and counts[False][2] == 0
    assert counts[True][3] == counts[False][3] > 0
    # one setup and one pack a bin state on the compact route, none on K5's
    builds = counts[True][1] if route == "compact" else 0
    assert counts[True][4:] == counts[False][4:] == (builds, builds)


def _mini_arm_search_scene(dev, H=192, W=256):
    """The mini arm on the card (the scoring renderer takes UNFUSED's tiles
    and cap), two frames, and its masks from a look-at pose."""
    from easyhec_torch.models.pose_init import lookat_init
    from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf

    names = ["base", "upper", "fore"]
    model = parse_urdf(ROOT / "assets" / "mini_arm.urdf")
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=names)
    r = RobotRenderer([meshes[n] for n in names], H, W, tile=UNFUSED, device=dev)
    idx = [chain.link_names.index(n) for n in names]
    lp = np.stack([chain.fk(torch.tensor(q))[idx].numpy()
                   for q in ([0.3, -0.4], [-0.2, 0.5])]).astype(np.float32)
    K = np.array([[240.0, 0, W / 2], [0, 240.0, H / 2], [0, 0, 1]], np.float32)
    T = torch.from_numpy(lookat_init([0.9, 0.5, 0.6], [0, 0, 0.2])).to(dev)
    with torch.no_grad():
        masks = (r.silhouette(T, torch.from_numpy(lp).to(dev), torch.from_numpy(K).to(dev))
                 > 0.5).float().cpu().numpy()
    return r, lp, K, masks


@pytest.mark.parametrize("kw", [{}, dict(n_dirs=13, radii=(0.9, 1.3), n_roll=3,
                                         refine_steps=20)], ids=["default3072", "ragged78"])
def test_graphed_search_matches_eager(dev, kw, monkeypatch):
    """global_search_init graphed (the sweep one graph replayed per batch of
    64, the moment refine one graph, the Adam step one graph replayed per
    step) and eager (_graphs) on the mini
    arm at 24x32 scoring renders: the scores, tiles_at_cap, Tc_c2b and
    score equal bit for bit, with equal K5 launch counts (one K5f per sweep
    batch, moment iteration and step, plus the final IoU; one counted K5b
    per step); the graphed call replays its graphs that often, the eager
    one never. At 3072 candidates (48 full batches) and at 78 (a ragged
    batch of 14 padded to 64)."""
    from easyhec_torch.models import pose_init
    from easyhec_torch.ops import tile_raster as tr_

    r, lp, K, masks = _mini_arm_search_scene(dev)
    kernels = (tr_.tile_fwd_cuda, tr_.tile_bwd_counted_cuda, tr_.tile_bwd_cuda)
    replays = _count_replays(monkeypatch)
    out, counts = {}, {}
    for graphed in (True, False):
        _graphs(graphed, monkeypatch)
        for k in kernels:
            k.launches = 0
        replays.clear()
        out[graphed] = pose_init.global_search_init(r, lp, K, masks, **kw)
        torch.cuda.synchronize()
        counts[graphed] = ([k.launches for k in kernels], len(replays))
    g, e = out[True], out[False]
    assert np.array_equal(g.scores, e.scores) and np.array_equal(g.poses, e.poses)
    assert np.array_equal(g.Tc_c2b, e.Tc_c2b) and g.score == e.score
    assert g.tiles_at_cap == e.tiles_at_cap
    n = g.scores.size
    steps = kw.get("refine_steps", 200)
    nb = -(-n // 64)
    assert n == (3072 if not kw else 78)
    assert counts[True][0] == counts[False][0] == [nb + 2 + steps + 1, steps, 0]
    assert counts == {True: (counts[True][0], nb + 1 + steps), False: (counts[True][0], 0)}
    assert np.isfinite(g.Tc_c2b).all() and 0 < g.score <= 1


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_graphed_find_lr_matches_eager(dev, optimizer, monkeypatch):
    """find_lr over the compact mask loss on one bin state, graphed (one step
    graph replayed per step) and eager (_graphs), 40 steps: the losses
    equal bit for bit, one K2f and one K2b per step in both."""
    from easyhec_torch.models.calib import mask_loss, tile_masks
    from easyhec_torch.solver import lr_finder

    r, st, t = _scene(dev, True)
    ref = tile_masks(t["target"], r)
    d0 = t["xi"] + 0.01
    replays = _count_replays(monkeypatch)
    out, counts = {}, {}
    for graphed in (True, False):
        _graphs(graphed, monkeypatch)
        prc.loss_fwd_compact_cuda.launches = prc.loss_bwd_compact_cuda.launches = 0
        replays.clear()
        out[graphed] = lr_finder.find_lr(
            lambda d: mask_loss(d, r, t["lp"], t["K"], t["target"], bin_state=st,
                                ref_tiles=ref), d0, 1e-5, 1e-1, 40, optimizer=optimizer)
        counts[graphed] = (prc.loss_fwd_compact_cuda.launches,
                           prc.loss_bwd_compact_cuda.launches, len(replays))
    assert np.array_equal(out[True].losses, out[False].losses)
    assert np.isfinite(out[True].losses).all()
    assert out[True].suggestion == out[False].suggestion
    assert counts == {True: (40, 40, 40), False: (40, 40, 0)}


def test_find_lr_capture_failure_raises(dev):
    """A loss that reads the device from the host (.item()) cannot be
    captured: find_lr raises, as JAX's jit fails on it, with no eager
    fallback. Last in the file, with the default stream restored after it:
    were capture_end to fail as well, torch.cuda.graph would leave the
    thread on its capture stream."""
    from easyhec_torch.solver.lr_finder import find_lr

    def loss_fn(x):
        loss = torch.sum((x - 1.0) ** 2)
        return loss * (1.0 if loss.item() > 0 else 2.0)

    try:
        with pytest.raises(RuntimeError):
            find_lr(loss_fn, torch.zeros(3, device=dev), num_steps=5)
    finally:
        torch.cuda.set_stream(torch.cuda.default_stream(dev))
        torch.cuda.synchronize()
