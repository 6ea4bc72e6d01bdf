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


# Tiles above one block of threads (32×128 = 4096 pixels, 4 pixel
# sub-blocks): the dense and compact kernels against their plain versions.
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
    assert pr.n_sub(meta) == 4
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


# The unfused tile rasterizer (K5) on real records of the unfused route.
UNFUSED = TileConfig(16, 32, 200, binner="count", margin=2.0)


@pytest.mark.parametrize("th,tw", [(16, 32), (32, 48)])
def test_tile_raster_matches_plain(dev, th, tw):
    from easyhec_torch.ops import tile_raster as tr_
    from easyhec_torch.render.binning import fields_and_bins, pack_records_counted

    r, _, t = _dense_scene(dev, False)
    r.tile = UNFUSED._replace(tile_h=th, tile_w=tw)
    B = t["lp"].shape[0]
    tris = r._triangles_soa(r.camera_link_poses(se3.exp(t["xi"]), t["lp"]), t["K"])
    fields, st = fields_and_bins(tris, HD, WD, r.tile)
    assert not bool(st.overflow.any())
    rec = pack_records_counted(fields, st.idx, st.q, -(-WD // tw), th, tw, 16)
    rec = torch.nn.functional.pad(rec, (0, 56)).contiguous()  # cap 200 -> 256
    counts = st.counts.contiguous()
    meta = tr_.TileMeta(th, tw, 1.0)
    ok, acck = tr_.tile_fwd_cuda(rec, counts, meta)
    op, accp = tr_.tile_fwd_plain(rec, counts, meta)
    torch.cuda.synchronize()
    np.testing.assert_allclose(ok.cpu(), op.cpu(), atol=1e-5)
    np.testing.assert_allclose(acck.clamp(max=2).cpu(), accp.clamp(max=2).cpu(), atol=1e-5)
    g = torch.randn(ok.shape, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    dk = tr_.tile_bwd_cuda(rec, counts, acck, g, meta)
    dp = tr_.tile_bwd_plain(rec, counts, acck, g, meta)
    torch.cuda.synchronize()
    scale = dp.abs().max().item()
    assert scale > 0 and B == 3
    np.testing.assert_allclose(dk.cpu(), dp.cpu(), rtol=0, atol=1e-4 * scale)
    assert (dk[..., 13:, :] == 0).all()


def test_unfused_silhouette_cuda_matches_cpu_and_counts_launches(dev):
    from easyhec_torch.ops import tile_raster as tr_

    out = []
    for d in (dev, torch.device("cpu")):
        r, _, t = _dense_scene(d, False)
        r.tile = UNFUSED
        xi = (t["xi"] + 0.01).requires_grad_()
        f0, b0 = tr_.tile_fwd_cuda.launches, tr_.tile_bwd_cuda.launches
        img = r.silhouette(se3.exp(xi), t["lp"], t["K"])
        ((img - t["target"]) ** 2).sum().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert (tr_.tile_fwd_cuda.launches, tr_.tile_bwd_cuda.launches) == (f0 + 1, b0 + 1)
        out.append((img.detach().cpu().numpy(), xi.grad.cpu().numpy()))
    (ik, gk), (ip, gp) = out
    np.testing.assert_allclose(ik, ip, atol=1e-4)
    np.testing.assert_allclose(gk, gp, rtol=1e-3, atol=1e-3 * np.abs(gp).max())
