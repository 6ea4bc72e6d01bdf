#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (easyhec_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--profile DIR]

Run from the root of a checkout; it imports nothing of JAX or easyhec_tpu.
The bench scene: 10 frames of 640x480, f = 600, the procedural arm
(assets/mini_arm.urdf subdivided to 8 mm edges, 21,312 triangles), tiles of
16x32 with cap 1664, adaptive rebinning, Adam 3e-3 from xi + 0.01. It runs
on three routes: compact (256 chunks, kernels K2f/K2b), dense
(compact_chunks = 0, the default RenderConfig's: K1f/K1b for the loss,
K4f/K4b for the silhouette) and unfused (fused = False: the silhouette
through K5f/K5b, autograd through the record pack and the triangle setup).
Phases, in order (any failure exits non-zero):

1. Build: compile every CUDA kernel of easyhec_torch/ops/csrc with nvcc
   (sm_90a), one nvcc per source started together; print the build seconds
   and the card's name and power limit.
2. Kernels vs plain, at the full shapes on real bin states: the compact
   loss forward and backward (K2); the dense loss (K1) and silhouette (K4)
   forward and backward, K4b also through autograd on
   RobotRenderer.silhouette; the unfused rasterizer K5f (image, min(acc, 2))
   and K5b (dtri, and dTc through autograd on RobotRenderer.silhouette).
   Each kernel's CUDA-event time, its plain version's, and its bound for
   this data. Then K1, K2 and K4 on 32x128 tiles (four pixel sub-blocks per
   tile) against their plain versions.
3. Main paths: ``calibrate`` at the bench scene on the compact, dense and
   unfused routes, 1000 steps each. Asserts no overflow, a falling loss, and
   one loss (or K5) kernel pair launch per step.
4. Dense trainer: ``run_offline_calibration`` with an in-memory Config and
   CalibBatch. Asserts no overflow, a falling loss, one K1f and one K1b
   launch per step, one K4f launch per render_outputs call, the artifacts.
5. Silhouette gradient path: Adam steps on Σ(RobotRenderer.silhouette −
   mask)² through autograd: one K4f and one K4b launch per step.
6. Global search: ``global_search_init`` at its defaults on frame 0 (K5f
   251 launches, K5b 200); then ``run_offline_calibration`` on the compact
   route with init_method="global_search" (the overflow pre-check adds one
   K5f).
7. Reference checks on small inputs, compact, dense and unfused, and a
   small global search: the card against the plain versions on the CPU.

Prints the kernel table as one JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. With --profile DIR it
also replays the compact and the dense ``calibrate`` runs under
torch.profiler and writes each run's device busy share and per-step
breakdown into DIR.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

H, W, B = 480, 640, 10
DEVICE = "cuda"  # the card every phase runs on (the reference checks add the CPU)
F_PX = 600.0
TH, TW = 16, 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, non-tensor FP32
# Arithmetic per (triangle lane, pixel) pair and per lane, counted from the
# kernel source: 3 edge functions (4 ops each), 4 bbox distances + 3 mins,
# the 4-way min (3), the clamp (4), the accumulate (1) = 27 forward ops; the
# backward recomputes coverage and adds the band test, the arms and the sums
# (~40); per-lane setup ~120 ops, the backward's chain ~100 more.
OPS_FWD_PAIR, OPS_BWD_PAIR = 27, 40
OPS_FWD_LANE, OPS_BWD_LANE = 120, 220
CHUNK_BYTES = 12 * 128 * 4  # one chunk of records


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def build_scene(device, H=H, W=W, B=B, max_edge=0.008, cap=1664, nc=256, fused=True,
                th=TH, tw=TW):
    """The bench workload's scene on `device`: (renderer, lp, K, xi_gt, qs).
    nc = 0 selects the dense route, fused=False the unfused one (K5)."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import camera, se3
    from easyhec_torch.render import RobotRenderer, TileConfig
    from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
    from easyhec_torch.robot.mesh import subdivide_to_max_edge

    model = parse_urdf(ROOT / "assets" / "mini_arm.urdf")
    chain = build_chain(model)
    names = ["base", "upper", "fore"]
    meshes = load_link_meshes(model, link_names=names)
    mesh_list = [subdivide_to_max_edge(meshes[n], max_edge) for n in names]
    tile = TileConfig(
        tile_h=th, tile_w=tw, capacity=cap, binner="count", rect_y=5, rect_x=3,
        margin=2.0, cull_backfaces=True, fused=fused, bwd_band_only=True,
        bin_big_k=6144, bin_subsort_rows=True, compact_chunks=nc if fused else 0,
        bwd_chunks=0,
    )
    renderer = RobotRenderer(mesh_list, H, W, tile=tile, device=device)
    f = F_PX * W / 640.0
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], device=device)
    Tcam = camera.look_at(
        torch.tensor([1.0, 0.7, 0.8], device=device),
        torch.tensor([0.0, 0.0, 0.3], device=device),
        torch.tensor([0.0, 0.0, 1.0], device=device),
    )
    xi = se3.log(se3.inverse(Tcam))
    lim = chain.joint_limits * 0.4
    qs = np.random.default_rng(0).uniform(lim[:, 0], lim[:, 1], (B, chain.n_dof))
    lp = chain.fk(torch.tensor(qs, dtype=torch.float32, device=device))
    lp = lp[:, [chain.link_index(n) for n in names]]
    return renderer, lp, K, xi, qs


def _bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for this much work."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _needed_work(cam, frames, gps, meta):
    """The work that THIS data needs from a loss or silhouette kernel pair,
    on either route.

    frames: per frame, (blk [n, 12, 128] record chunks in tile order, ct [n]
    their tiles, nlive [n] their live slots); gps: {name: [B, T, P]} the
    masked cotangents of the backward kernels. A lane-pixel pair counts when
    its lane is a live slot whose coverage can be nonzero in its tile (valid,
    bbox within the soft band of the tile); lanes are the live slots set up.
    Forward chunks that the saturation early-out skips, and backward chunks
    with no live cotangent pixel, are not counted. A tile is visited when it
    has a live slot: the backward needs acc and ref (or g) of visited tiles
    only, since the parts of the others are zero. Returns {"fwd": [pairs,
    lanes, chunks], name: [pairs, lanes, chunks], "tiles": visited tiles}."""
    import torch

    from easyhec_torch.ops.pose_raster import (
        CHUNK, _chunk_coverage, _chunk_setup, pix_grids, tile_origin,
    )

    dev = cam.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    reach = 0.5 / meta.sharpness + 1.0
    work = {"fwd": [0, 0, 0], "tiles": 0, **{k: [0, 0, 0] for k in gps}}
    for b, (blk, ct, nl) in enumerate(frames):
        n = ct.numel()
        if n == 0:
            continue
        x0, y0 = tile_origin(ct, meta.n_tx, meta.th, meta.tw)
        s = _chunk_setup(blk, cam[b].expand(n, 16), x0, y0, meta.near, meta.far)
        live_slot = torch.arange(CHUNK, device=dev) < nl[:, None]
        lox, loy, hix, hiy = s["bbox"]
        ok = (s["valid"] & live_slot & (hix + reach > 0) & (lox - reach < meta.tw)
              & (hiy + reach > 0) & (loy - reach < meta.th))
        cov, *_ = _chunk_coverage(s, px, py, meta.sharpness)
        delta = torch.einsum("ncp,nc->np", cov, live_slot.float())
        ar = torch.arange(n, device=dev)
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = ct[1:] != ct[:-1]
        start = torch.cummax(torch.where(first, ar, 0), 0)[0]
        cs = torch.cumsum(delta, dim=0)
        base = torch.where((start > 0)[:, None], cs[(start - 1).clamp(min=0)], 0.0)
        run = (nl > 0) & ~((cs - delta - base).amin(dim=-1) >= 2.0)
        nok, nslot = ok.sum(-1), live_slot.sum(-1)
        uses = {"fwd": (run, nok * meta.th * meta.tw)}  # (chunks run, pairs)
        for k, gp in gps.items():
            live_px = (gp[b][ct] != 0).sum(dim=-1)
            uses[k] = ((nl > 0) & (live_px > 0), nok * live_px)
        for k, (use, pairs) in uses.items():
            w = work[k]
            w[0] += int((pairs * use).sum())
            w[1] += int((nslot * use).sum())
            w[2] += int(use.sum())
        work["tiles"] += int(torch.unique(ct[nl > 0]).numel())
    return work


def _ops(w, pair_ops, lane_ops):
    return w[0] * pair_ops + w[1] * lane_ops


def _check_loss_fwd(tag, got, want):
    """A loss forward's (per-tile loss [B, T], acc) against its plain
    version's; returns the per-tile loss's max abs error."""
    import torch

    (lk, acck), (lp, accp) = got, want
    torch.cuda.synchronize()
    fk, fp = lk.sum(-1), lp.sum(-1)
    err = (lk - lp).abs().max().item()
    frame_rel = ((fk - fp).abs() / fp.abs().clamp(min=1e-6)).max().item()
    acc_err = (acck.clamp(max=2) - accp.clamp(max=2)).abs().max().item()
    # Tolerances: the per-frame loss sums 512 pixels x ~600 tiles in another
    # order (rtol 1e-4). acc sums up to ~1,300 lane coverages per pixel, and
    # nvcc contracts each edge function a*px + b*py + c into FMAs, which
    # rounds differently by ~1e-6 per term (|c| is up to the tile size):
    # atol 1e-3 on min(acc, 2).
    print(f"[kernels] {tag} loss: max abs err per tile {err:.3e}, per frame rel "
          f"{frame_rel:.3e} (tol rtol 1e-4); min(acc,2) max abs err {acc_err:.3e} "
          "(tol 1e-3). Reason: summation order over lanes, pixels and tiles; FMA "
          "contraction of the edge functions")
    if not (frame_rel <= 1e-4 and acc_err <= 1e-3):
        raise AssertionError(f"{tag} disagrees with its plain version")
    return err


def _check_dcam(tag, dk, dp):
    """A backward's dcam [B, 16] against its plain version's; returns the max
    abs error."""
    import torch

    torch.cuda.synchronize()
    scale = dp.abs().max().item()
    err = (dk - dp).abs().max().item()
    print(f"[kernels] {tag} dcam: max abs err {err:.3e}, max|dcam| {scale:.3e} "
          "(tol 1e-3*max|dcam|). Reason: summation order over lanes and pixels")
    if not (scale > 0 and err <= 1e-3 * scale):
        raise AssertionError(f"{tag} disagrees with its plain version")
    return err


def _row(name, tag, source, replaces, err, run, plain, nbytes, ops):
    """Time a kernel (CUDA events, mean of 50 launches) and its plain
    version (3), bound its work, print them and return its kernels-line row."""
    ms = _time_ms(run, 50)
    plain_ms = _time_ms(plain, 3, warm=1)
    bms, bby = _bound(nbytes, ops)
    print(f"[kernels] {tag} {ms:.4f} ms (plain {plain_ms:.3f} ms), needs {nbytes} "
          f"bytes, {ops} operations -> bound {bms:.4f} ms ({bby})")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=None)


def _print_work(route, w):
    print(f"[kernels] {route} work at the start pose: forward {w['fwd'][0]} lane-pixel "
          f"pairs over {w['fwd'][2]} chunks; {w['tiles']} visited tiles; backward "
          + ", ".join(f"{k} {v[0]} live pairs over {v[2]} chunks"
                      for k, v in w.items() if k not in ("fwd", "tiles")))


def kernel_phase(renderer, lp, K, xi, target):
    """Phase 2, compact route: K2f and K2b against their plain versions at
    full shapes. Returns the per-kernel measurements."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import tile_masks
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops.pose_raster import loss_cotangent
    from easyhec_torch.render.fused import cam_rows

    d0 = xi + 0.01
    st = renderer.bin_state(se3.exp(d0), lp, K)
    if bool(st.overflow):
        raise AssertionError("bin overflow at the start pose")
    cam = cam_rows(se3.exp(d0), K, B).contiguous()
    ref = tile_masks(target, renderer).contiguous()
    cfg = renderer.tile
    meta = prc.Meta(TH, TW, -(-W // TW), H, W, 1.0, 0.001, 10.0, cfg.bwd_band_only)
    fargs = (cam, st.rec, st.nlive, st.ctmap, st.ncu, ref, meta)
    got = prc.loss_fwd_compact_cuda(*fargs)
    f_err = _check_loss_fwd("K2f", got, prc.loss_fwd_compact_plain(*fargs))
    acck = got[1]
    gb = torch.full((B,), 1.0 / B, device=cam.device)
    bargs = (cam, st.rec, st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref, acck, gb, meta)
    b_err = _check_dcam("K2b", prc.loss_bwd_compact_cuda(*bargs).sum(1),
                        prc.loss_bwd_compact_plain(*bargs).sum(1))
    print(f"[kernels] start-pose loads: max tile count {int(st.counts.max())} "
          f"(cap {cfg.capacity}), max ncu {int(st.ncu.max())} (budget {cfg.compact_chunks})")

    T, P, nc = ref.shape[1], TH * TW, st.nlive.shape[1]
    frames = [(prc._chunks_of(st.rec[b]), st.ctmap[b].long(), st.nlive[b].long())
              for b in range(B)]
    gp = loss_cotangent(acck.reshape(B, T, P), ref.reshape(B, T, P), gb[:, None, None],
                        torch.arange(T, device=cam.device), meta)
    w = _needed_work(cam, frames, {"K2b": gp}, meta)
    _print_work("compact", w)
    maps = B * (nc * 8 + 4 + 64)  # nlive and ctmap (or cpos), ncu (or gb), cam
    src = "easyhec_torch/ops/csrc/pose_raster_compact.cu"
    return [
        # records of the chunks run and ref of visited tiles in; acc and loss out
        _row("loss_fwd_compact", "K2f", src, "easyhec_tpu/ops/pose_raster_compact.py:66",
             f_err, lambda: prc.loss_fwd_compact_cuda(*fargs),
             lambda: prc.loss_fwd_compact_plain(*fargs),
             w["fwd"][2] * CHUNK_BYTES + w["tiles"] * P * 4 + B * T * (P + 1) * 4 + maps,
             _ops(w["fwd"], OPS_FWD_PAIR, OPS_FWD_LANE)),
        # records of the live chunks and acc + ref of visited tiles in; parts out
        _row("loss_bwd_compact", "K2b", src, "easyhec_tpu/ops/pose_raster_compact.py:105",
             b_err, lambda: prc.loss_bwd_compact_cuda(*bargs),
             lambda: prc.loss_bwd_compact_plain(*bargs),
             w["K2b"][2] * CHUNK_BYTES + w["tiles"] * 2 * P * 4 + maps + B * nc * (4 + 48),
             _ops(w["K2b"], OPS_BWD_PAIR, OPS_BWD_LANE)),
    ]


def check_tile_acc(renderer, K, xi, st):
    """compact_tile_acc (the forward kernel with a zero reference, which
    rendered the target masks) against the plain forward at the GT pose."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.render.fused import cam_rows

    T = st.counts.shape[1]
    cam = cam_rows(se3.exp(xi), K, B).contiguous()
    acc_k = prc.compact_tile_acc(cam, st.rec, st.nlive, st.ctmap, st.ncu, T, TH, TW,
                                 -(-W // TW), H, W)
    zeros = torch.zeros_like(acc_k)
    meta = prc.Meta(TH, TW, -(-W // TW), H, W)
    _, acc_p = prc.loss_fwd_compact_plain(cam, st.rec, st.nlive, st.ctmap, st.ncu,
                                          zeros, meta)
    err = (acc_k.clamp(max=2) - acc_p.clamp(max=2)).abs().max().item()
    print(f"[kernels] compact_tile_acc (K2f, zero reference): min(acc,2) max abs "
          f"err {err:.3e} (tol 1e-3, as for K2f)")
    if not err <= 1e-3:
        raise AssertionError("compact_tile_acc disagrees with the plain forward")


def _dense_frames(rec, counts):
    """Per frame, the used chunks of the dense records as _needed_work takes
    them: (blk, tile, live slots), chunk j of a tile holding slots
    [128 j, 128 (j + 1)) of its count."""
    import torch

    from easyhec_torch.ops.pose_raster import CHUNK, _dense_chunks

    cap = rec.shape[-1] // counts.shape[1]
    frames = []
    for b in range(counts.shape[0]):
        cnt = counts[b].long().clamp(0, cap)
        blk, ct = _dense_chunks(rec[b], counts[b], cap)
        used = -(-cnt // CHUNK)
        j = torch.arange(ct.numel(), device=ct.device) - (torch.cumsum(used, 0) - used)[ct]
        frames.append((blk, ct, (cnt[ct] - j * CHUNK).clamp(0, CHUNK)))
    return frames


def dense_kernel_phase(renderer, lp, K, xi, target):
    """The dense kernels (K1f, K1b, K4f, K4b) against their plain versions at
    the bench scene's full shapes, on the dense bin state at the start pose.
    K4b is also taken by torch.autograd.grad through RobotRenderer.silhouette.
    Returns the per-kernel measurements."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import tile_masks
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops.pose_raster import tile_image
    from easyhec_torch.render.fused import cam_rows
    from easyhec_torch.render.tiled import _untile

    d0 = xi + 0.01
    st = renderer.bin_state(se3.exp(d0), lp, K)
    if bool(st.overflow.any()):
        raise AssertionError("dense bin overflow at the start pose")
    rec = pr._pad_records(st.rec, st.counts)
    counts = pr.i32(st.counts)
    cam = cam_rows(se3.exp(d0), K, B).contiguous()
    ref = tile_masks(target, renderer).contiguous()
    cfg = renderer.tile
    meta = pr.Meta(TH, TW, -(-W // TW), H, W, 1.0, 0.001, 10.0, cfg.bwd_band_only)
    T = counts.shape[1]
    print(f"[dense] start-pose loads: max tile count {int(st.counts.max())} (cap "
          f"{cfg.capacity}), {int((st.counts > 0).sum())} of {B * T} tiles visited; "
          f"records {rec.numel() * 4} bytes")

    # K1f: per-tile loss and min(acc, 2); K1b: dcam for gb = 1/B (the
    # gradient of the mean over frames).
    fargs = (cam, rec, counts, ref, meta)
    got = pr.loss_fwd_cuda(*fargs)
    k1f_err = _check_loss_fwd("K1f", got, pr.loss_fwd_plain(*fargs))
    acck = got[1]
    gb = torch.full((B,), 1.0 / B, device=cam.device)
    bargs = (cam, rec, counts, ref, acck, gb, meta)
    k1b_err = _check_dcam("K1b", pr.loss_bwd_cuda(*bargs).sum(1),
                          pr.loss_bwd_plain(*bargs).sum(1))

    # K4f: the clipped image (tolerance of min(acc, 2)).
    sargs = (cam, rec, counts, meta)
    sk, acc_s = pr.sil_fwd_cuda(*sargs)
    spl, _ = pr.sil_fwd_plain(*sargs)
    torch.cuda.synchronize()
    k4f_err = (sk - spl).abs().max().item()
    print(f"[kernels] K4f image: max abs err {k4f_err:.3e} (tol 1e-3, as min(acc,2))")
    if not k4f_err <= 1e-3:
        raise AssertionError("K4f disagrees with its plain version")

    # K4b: the cotangent of mean Σ(sil − target)², through the wrapper and
    # through autograd on RobotRenderer.silhouette (same bin state).
    g_img = 2.0 * (_untile(sk, H, W, cfg) - target) / B
    g_t = tile_image(g_img, TH, TW).contiguous()
    gargs = (cam, rec, counts, acc_s, g_t, meta)
    qpl = pr.sil_bwd_plain(*gargs).sum(1)
    k4b_err = _check_dcam("K4b", pr.sil_bwd_cuda(*gargs).sum(1), qpl)
    Tc = se3.exp(d0).detach().requires_grad_()
    n0 = pr.sil_bwd_cuda.launches
    sil = renderer.silhouette(Tc, lp, K, bin_state=st)
    (gT,) = torch.autograd.grad(sil, Tc, g_img)
    torch.cuda.synchronize()
    if pr.sil_bwd_cuda.launches != n0 + 1:
        raise AssertionError("autograd through RobotRenderer.silhouette did not launch K4b")
    want = qpl[:, :12].sum(0)
    ag_err = (gT[:3, :4].reshape(12) - want).abs().max().item()
    print(f"[kernels] K4b through autograd on RobotRenderer.silhouette vs plain: "
          f"{ag_err:.3e} of max {want.abs().max().item():.3e} (tol 1e-3*max). "
          "Reason: summation order")
    if not ag_err <= 1e-3 * want.abs().max().item():
        raise AssertionError("K4b through autograd disagrees with its plain version")

    P = TH * TW
    gps = {
        "K1b": pr.loss_cotangent(acck.reshape(B, T, P), ref.reshape(B, T, P),
                                 gb[:, None, None], torch.arange(T, device=cam.device), meta),
        "K4b": pr.image_cotangent(acc_s, g_t, meta).reshape(B, T, P),
    }
    w = _needed_work(cam, _dense_frames(rec, counts), gps, meta)
    _print_work("dense", w)
    img = B * T * P * 4
    small = B * T * 4 + B * 64  # counts, cam
    fwd_bytes = w["fwd"][2] * CHUNK_BYTES + small + 2 * img  # + (K1f) ref in, or image out
    fwd_ops = _ops(w["fwd"], OPS_FWD_PAIR, OPS_FWD_LANE)

    def bwd_bytes(k):  # records of the live chunks, acc + ref (or g) of visited tiles; parts out
        return w[k][2] * CHUNK_BYTES + w["tiles"] * 2 * P * 4 + small + B * T * 48

    src = "easyhec_torch/ops/csrc/pose_raster.cu"
    at = "easyhec_tpu/ops/pose_raster.py:"
    return [
        _row("loss_fwd", "K1f", src, at + "648", k1f_err, lambda: pr.loss_fwd_cuda(*fargs),
             lambda: pr.loss_fwd_plain(*fargs), fwd_bytes + B * T * 4, fwd_ops),
        _row("loss_bwd", "K1b", src, at + "681", k1b_err, lambda: pr.loss_bwd_cuda(*bargs),
             lambda: pr.loss_bwd_plain(*bargs), bwd_bytes("K1b") + B * 4,
             _ops(w["K1b"], OPS_BWD_PAIR, OPS_BWD_LANE)),
        _row("sil_fwd", "K4f", src, at + "167", k4f_err, lambda: pr.sil_fwd_cuda(*sargs),
             lambda: pr.sil_fwd_plain(*sargs), fwd_bytes, fwd_ops),
        _row("sil_bwd", "K4b", src, at + "490", k4b_err, lambda: pr.sil_bwd_cuda(*gargs),
             lambda: pr.sil_bwd_plain(*gargs), bwd_bytes("K4b"),
             _ops(w["K4b"], OPS_BWD_PAIR, OPS_BWD_LANE)),
    ]


def _k5_records(r, lp, K, Tc, state=None):
    """Tile-local edge records of the unfused route at pose Tc: (rec [B, T,
    16, cap], BinState); differentiable in Tc through the record pack."""
    from easyhec_torch.ops.tile_raster import TRI_RECORD
    from easyhec_torch.render.binning import fields_and_bins, pack_records_counted
    from easyhec_torch.render.tiled import _edge_fields_soa

    import torch

    tris = r._triangles_soa(r.camera_link_poses(Tc, lp), K)
    if state is None:
        fields, state = fields_and_bins(tris, r.H, r.W, r.tile)
    else:
        fields = torch.stack(_edge_fields_soa(tris), dim=-2)
    cfg = r.tile
    rec = pack_records_counted(fields, state.idx, state.q, -(-r.W // cfg.tile_w),
                               cfg.tile_h, cfg.tile_w, TRI_RECORD)
    return rec, state


def _k5_work(rec, counts, gp, meta):
    """The work that THIS data needs from K5, by the rule of _needed_work: a
    lane-pixel pair counts when its slot is live and its band-dilated bbox
    reaches the tile; forward chunks that the saturation early-out skips are
    not counted; the backward visits only the live cotangent pixels of its
    tile (gp [B, T, P] = g·1{acc <= 1}). Returns {"fwd": [pairs, chunks],
    "bwd": [pairs, chunks], "bwd_tiles": tiles with a live pixel}."""
    import torch

    from easyhec_torch.ops.pose_raster import pix_grids
    from easyhec_torch.ops.tile_raster import CHUNK, TRI_RECORD, _blocks, _chunk_coverage, \
        _used_chunks

    B, T, _, cap = rec.shape
    P = meta.th * meta.tw
    flat = rec.reshape(B * T, TRI_RECORD, cap // CHUNK, CHUNK)
    tile, j, rem = _used_chunks(counts.reshape(-1), cap)
    blk = flat[tile, :, j]
    dev = rec.device
    reach = 0.5 / meta.sharpness + 1.0
    live = torch.arange(CHUNK, device=dev)[None, :] < rem[:, None]
    ok = (live & (blk[:, 11] + reach > 0) & (blk[:, 9] - reach < meta.tw)
          & (blk[:, 12] + reach > 0) & (blk[:, 10] - reach < meta.th))
    nok = ok.sum(-1)
    px, py = pix_grids(meta.th, meta.tw, dev)
    delta = torch.cat([_chunk_coverage(blk[a:b], rem[a:b], px, py, meta.sharpness)[0].sum(1)
                       for a, b in _blocks(tile.numel(), P)])
    n = tile.numel()
    ar = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = tile[1:] != tile[:-1]
    start = torch.cummax(torch.where(first, ar, 0), 0)[0]
    cs = torch.cumsum(delta, dim=0)
    base = torch.where((start > 0)[:, None], cs[(start - 1).clamp(min=0)], 0.0)
    run = ~((cs - delta - base).amin(dim=-1) >= 2.0)
    live_px = (gp.reshape(B * T, P) != 0).sum(-1)[tile]
    use = live_px > 0
    return {"fwd": [int((nok * P * run).sum()), int(run.sum())],
            "bwd": [int((nok * live_px * use).sum()), int(use.sum())],
            "bwd_tiles": int((gp.reshape(B * T, P) != 0).any(-1).sum())}


def unfused_kernel_phase(r, lp, K, xi, target):
    """K5f and K5b against their plain versions at the full shapes of the
    unfused route, on the records at the start pose; K5b also through
    autograd on RobotRenderer.silhouette down to dTc, against the plain
    K5b's dtri chained through the same record pack. Returns the rows."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import tile_raster as tr
    from easyhec_torch.ops.pose_raster import tile_image
    from easyhec_torch.render.tiled import _untile

    cfg = r.tile
    Tc = se3.exp(xi + 0.01).detach()
    with torch.no_grad():
        rec, st = _k5_records(r, lp, K, Tc)
    if bool(st.overflow.any()):
        raise AssertionError("unfused bin overflow at the start pose")
    rec, counts = rec.contiguous(), st.counts.contiguous()
    T = counts.shape[1]
    print(f"[unfused] start-pose loads: max tile count {int(counts.max())} (cap "
          f"{cfg.capacity}), {int((counts > 0).sum())} of {B * T} tiles visited; records "
          f"{rec.numel() * 4} bytes")
    meta = tr.TileMeta(TH, TW, 1.0)
    ok_, acck = tr.tile_fwd_cuda(rec, counts, meta)
    op_, accp = tr.tile_fwd_plain(rec, counts, meta)
    torch.cuda.synchronize()
    img_err = (ok_ - op_).abs().max().item()
    acc_err = (acck.clamp(max=2) - accp.clamp(max=2)).abs().max().item()
    print(f"[kernels] K5f image: max abs err {img_err:.3e}; min(acc,2) max abs err "
          f"{acc_err:.3e} (tol 1e-3 each, as K1f/K2f: summation order over slots, FMA "
          "contraction of the edge functions)")
    if not (img_err <= 1e-3 and acc_err <= 1e-3):
        raise AssertionError("K5f disagrees with its plain version")

    g_img = 2.0 * (_untile(ok_, H, W, cfg) - target) / B  # d mean Σ(sil − target)²
    g_t = tile_image(g_img, TH, TW).contiguous()
    bargs = (rec, counts, acck, g_t, meta)
    dk, dp = tr.tile_bwd_cuda(*bargs), tr.tile_bwd_plain(*bargs)
    torch.cuda.synchronize()
    scale = dp.abs().max().item()
    d_err = (dk - dp).abs().max().item()
    print(f"[kernels] K5b dtri: max abs err {d_err:.3e}, max|dtri| {scale:.3e} (tol "
          "1e-3*max|dtri|). Reason: summation order over pixels")
    if not (scale > 0 and d_err <= 1e-3 * scale):
        raise AssertionError("K5b disagrees with its plain version")
    Tk = Tc.clone().requires_grad_()
    n0 = tr.tile_bwd_cuda.launches
    (gk,) = torch.autograd.grad(r.silhouette(Tk, lp, K, bin_state=st), Tk, g_img)
    Tp = Tc.clone().requires_grad_()
    (gp_,) = torch.autograd.grad(_k5_records(r, lp, K, Tp, st)[0], Tp, dp)
    torch.cuda.synchronize()
    if tr.tile_bwd_cuda.launches != n0 + 1:
        raise AssertionError("autograd through RobotRenderer.silhouette did not launch K5b")
    want = gp_[:3, :4]
    ag_err = (gk[:3, :4] - want).abs().max().item()
    print(f"[kernels] dTc through autograd on RobotRenderer.silhouette (K5b) vs the plain "
          f"K5b's dtri through the same record pack: {ag_err:.3e} of max "
          f"{want.abs().max().item():.3e} (tol 1e-3*max). Reason: summation order")
    if not ag_err <= 1e-3 * want.abs().max().item():
        raise AssertionError("K5b through autograd disagrees with its plain version")

    P = TH * TW
    gp = (g_t * (acck <= 1.0).float()).reshape(B, T, P)
    w = _k5_work(rec, counts, gp, meta)
    print(f"[kernels] unfused work at the start pose: forward {w['fwd'][0]} lane-pixel pairs "
          f"over {w['fwd'][1]} chunks; backward {w['bwd'][0]} live pairs over {w['bwd'][1]} "
          f"chunks in {w['bwd_tiles']} tiles")
    chunk13 = 13 * CHUNK_BYTES // 12  # the 13 field rows of one 128-slot chunk
    img = B * T * P * 4
    src = "easyhec_torch/ops/csrc/tile_raster.cu"
    return [
        # records of the chunks run and counts in; clip(acc) and acc out
        _row("tile_fwd", "K5f", src, "easyhec_tpu/ops/tile_raster.py:95", max(img_err, acc_err),
             lambda: tr.tile_fwd_cuda(rec, counts, meta),
             lambda: tr.tile_fwd_plain(rec, counts, meta),
             w["fwd"][1] * chunk13 + B * T * 4 + 2 * img, w["fwd"][0] * OPS_FWD_PAIR),
        # records of the live chunks, acc and g of the live tiles in; dtri out
        _row("tile_bwd", "K5b", src, "easyhec_tpu/ops/tile_raster.py:121", d_err,
             lambda: tr.tile_bwd_cuda(*bargs), lambda: tr.tile_bwd_plain(*bargs),
             w["bwd"][1] * chunk13 + w["bwd_tiles"] * 2 * P * 4 + B * T * 4 + rec.numel() * 4,
             w["bwd"][0] * OPS_BWD_PAIR),
    ]


def large_tile_phase():
    """The repair: K1, K2 and K4 on 32×128 tiles (4096 pixels, four pixel
    sub-blocks per tile) at the bench scene, against their plain versions,
    with a cap above the measured tile loads."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import tile_masks
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.render.fused import build_fused_state, cam_rows

    th, tw = 32, 128
    probe, lp, K, xi, _ = build_scene(DEVICE, cap=16384, nc=0, th=th, tw=tw)
    d0 = xi + 0.01
    loads = build_fused_state(probe, se3.exp(d0), lp, K).counts
    cap = (int(loads.max()) // 128 + 1) * 128
    nc = int((-(-loads.long() // 128)).sum(-1).max()) + 8
    del probe
    dense, _, _, _, _ = build_scene(DEVICE, cap=cap, nc=0, th=th, tw=tw)
    comp, _, _, _, _ = build_scene(DEVICE, cap=cap, nc=nc, th=th, tw=tw)
    with torch.no_grad():
        target = (dense.silhouette(se3.exp(xi), lp, K) > 0.5).float()
    print(f"[kernels 32x128] tiles of {th}x{tw} ({th * tw} pixels, "
          f"{pr.n_sub(pr.Meta(th, tw, 1, H, W))} pixel sub-blocks); start-pose max load "
          f"{int(loads.max())} -> cap {cap}, compact budget {nc} chunks")
    meta = pr.Meta(th, tw, -(-W // tw), H, W, 1.0, 0.001, 10.0, True)
    cam = cam_rows(se3.exp(d0), K, B).contiguous()
    ref = tile_masks(target, dense).contiguous()
    gb = torch.full((B,), 1.0 / B, device=cam.device)
    st = dense.bin_state(se3.exp(d0), lp, K)
    cst = comp.bin_state(se3.exp(d0), lp, K)
    if bool(st.overflow.any()) or bool(cst.overflow):
        raise AssertionError("bin overflow on 32x128 tiles")
    rec, counts = pr._pad_records(st.rec, st.counts), pr.i32(st.counts)
    times = {}
    fa = (cam, rec, counts, ref, meta)
    got = pr.loss_fwd_cuda(*fa)
    _check_loss_fwd("K1f 32x128", got, pr.loss_fwd_plain(*fa))
    ba = (cam, rec, counts, ref, got[1], gb, meta)
    _check_dcam("K1b 32x128", pr.loss_bwd_cuda(*ba).sum(1), pr.loss_bwd_plain(*ba).sum(1))
    sk, acc_s = pr.sil_fwd_cuda(cam, rec, counts, meta)
    e4 = (sk - pr.sil_fwd_plain(cam, rec, counts, meta)[0]).abs().max().item()
    print(f"[kernels] K4f 32x128 image: max abs err {e4:.3e} (tol 1e-3)")
    if not e4 <= 1e-3:
        raise AssertionError("K4f on 32x128 tiles disagrees with its plain version")
    g = torch.randn(sk.shape, generator=torch.Generator(device=DEVICE).manual_seed(0),
                    device=DEVICE)
    ga = (cam, rec, counts, acc_s, g, meta)
    _check_dcam("K4b 32x128", pr.sil_bwd_cuda(*ga).sum(1), pr.sil_bwd_plain(*ga).sum(1))
    ca = (cam, cst.rec, cst.nlive, cst.ctmap, cst.ncu, ref, meta)
    got = prc.loss_fwd_compact_cuda(*ca)
    _check_loss_fwd("K2f 32x128", got, prc.loss_fwd_compact_plain(*ca))
    cb = (cam, cst.rec, cst.bwd_nlive, cst.bwd_ctmap, cst.bwd_cpos, ref, got[1], gb, meta)
    _check_dcam("K2b 32x128", prc.loss_bwd_compact_cuda(*cb).sum(1),
                prc.loss_bwd_compact_plain(*cb).sum(1))
    for name, fn in (("K1f", lambda: pr.loss_fwd_cuda(*fa)), ("K1b", lambda: pr.loss_bwd_cuda(*ba)),
                     ("K4f", lambda: pr.sil_fwd_cuda(cam, rec, counts, meta)),
                     ("K4b", lambda: pr.sil_bwd_cuda(*ga)),
                     ("K2f", lambda: prc.loss_fwd_compact_cuda(*ca)),
                     ("K2b", lambda: prc.loss_bwd_compact_cuda(*cb))):
        times[name] = _time_ms(fn, 20)
    print("[kernels 32x128] CUDA-event ms (mean of 20): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))


def _reset(kernels):
    for fn in kernels.values():
        fn.launches = 0


def main_path(renderer, lp, K, xi, target, steps, kernels, label):
    """``calibrate`` at full width on `renderer`'s route; kernels
    {name: (forward wrapper, backward wrapper)} names the loss pair that must
    run once per step. Returns (launches by name, ms/step)."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate

    d0 = (xi + 0.01).cpu().numpy()
    gt = se3.exp(xi).cpu().numpy()
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    res = calibrate(d0, renderer, lp, K, target, num_steps=steps, max_lr=3e-3,
                    rebin_every=0, Tc_c2b_gt=gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[{label}] {steps} steps in {dt:.3f} s: {dt / steps * 1e3:.3f} ms/step, "
          f"{steps * B * H * W / dt:.0f} px/s fwd+bwd, {res.rebins} rebins")
    print(f"[{label}] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; launches "
          f"{json.dumps(launches)}; pose error {json.dumps(res.metrics)}")
    if res.overflow:
        raise AssertionError(f"bin overflow during calibrate ({label})")
    if not (np.isfinite(res.losses).all() and np.isfinite(res.dof).all()):
        raise AssertionError("non-finite loss or pose")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError("loss did not fall")
    fwd, bwd = list(launches.values())
    if fwd < steps or bwd != steps:
        raise AssertionError(f"launch counts {launches} for {steps} steps ({label})")
    return launches, dt / steps * 1e3, res.rebins


def trainer_phase(lp, K, xi, qs, target, steps):
    """run_offline_calibration on the dense route at the bench scene, with an
    in-memory Config and CalibBatch (the GPU machine has no PyYAML or
    OpenCV, so nothing is read from disk but the URDF)."""
    import tempfile

    import numpy as np
    import torch

    from easyhec_torch.config import Config
    from easyhec_torch.data import CalibBatch
    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.trainer import offline

    cfg = Config()
    m, r, s = cfg.model, cfg.render, cfg.solver
    m.urdf_path = str(ROOT / "assets" / "mini_arm.urdf")
    m.use_links = ["base", "upper", "fore"]
    m.H, m.W, m.subdivide_max_edge = H, W, 0.008
    r.tile_h, r.tile_w, r.capacity, r.rect_y, r.rect_x = TH, TW, 1664, 5, 3
    r.margin, r.cull_backfaces, r.bin_big_k, r.bin_subsort_rows = 2.0, True, 6144, True
    r.compact_chunks = 0  # the dense route (RenderConfig's default)
    s.num_epochs, s.max_lr, s.rebin_every = steps, 3e-3, 0
    batch = CalibBatch(
        rgb=np.zeros((B, H, W, 3), np.uint8), masks=target.cpu().numpy(),
        qpos=qs.astype(np.float32), link_poses=lp.cpu().numpy(), K=K.cpu().numpy(),
        Tc_c2b_gt=se3.exp(xi).cpu().numpy(),
    )
    kernels = {"loss_fwd": pr.loss_fwd_cuda, "loss_bwd": pr.loss_bwd_cuda,
               "sil_fwd": pr.sil_fwd_cuda, "sil_bwd": pr.sil_bwd_cuda}
    calls = [0]
    real = offline.render_outputs

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        cfg.output_dir = tmp
        offline.render_outputs = counted
        torch.cuda.synchronize()
        _reset(kernels)
        try:
            res = offline.run_offline_calibration(cfg, batch=batch,
                                                  init_dof=(xi + 0.01).cpu().numpy())
        finally:
            offline.render_outputs = real
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        out = Path(tmp)
        want = ["Tc_c2b.txt", "metrics.json", "eval.json", "config.yaml",
                "checkpoints/final.npz", "metrics.jsonl"]
        missing = [f for f in want if not (out / f).is_file()]
        wall = json.loads((out / "checkpoints" / "final.json").read_text())["wall_time_s"]
        evals = json.loads((out / "eval.json").read_text())
    print(f"[trainer] run_offline_calibration, dense route: {steps} steps in "
          f"{wall:.3f} s (wall_time_s, with the step hooks' {steps // 100} mid-run panels "
          f"and checkpoints): {wall / steps * 1e3:.3f} ms/step, "
          f"{steps * B * H * W / wall:.0f} px/s; {res.rebins} rebins")
    print(f"[trainer] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; launches "
          f"{json.dumps(launches)}; render_outputs calls {calls[0]}; mask_iou "
          f"{evals.get('mask_iou', float('nan')):.4f}; pose error {json.dumps(res.metrics)}")
    if missing:
        raise AssertionError(f"trainer artifacts missing: {missing}")
    if res.overflow:
        raise AssertionError("bin overflow during the trainer run")
    if not (np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]):
        raise AssertionError("trainer loss did not fall")
    if launches["loss_fwd"] != steps or launches["loss_bwd"] != steps:
        raise AssertionError(f"K1 launches {launches} for {steps} steps")
    if calls[0] == 0 or launches["sil_fwd"] != calls[0]:
        raise AssertionError(f"K4f launches {launches['sil_fwd']} for "
                             f"{calls[0]} render_outputs calls")
    return launches, wall / steps * 1e3


def search_phase(renderer, lp, K, xi, target):
    """global_search_init at its defaults on frame 0 (3072 candidates scored
    at 1/8 resolution in batches of 64, moments, 200 Adam steps on the top
    16): one K5f per batch, per moment iteration and per step, plus the
    final IoU; one K5b per step. Returns the launches."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import pose_metrics
    from easyhec_torch.models.pose_init import global_search_init
    from easyhec_torch.ops import tile_raster as tr

    kernels = {"tile_fwd": tr.tile_fwd_cuda, "tile_bwd": tr.tile_bwd_cuda}
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    res = global_search_init(renderer, lp[0].cpu().numpy(), K.cpu().numpy(),
                             target[0].cpu().numpy())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    gt = se3.exp(xi).cpu().numpy()
    err = pose_metrics(se3.log(torch.from_numpy(res.Tc_c2b)).numpy(), gt)

    def center(T):  # camera center in the base frame, unit
        c = -T[:3, :3].T @ T[:3, 3]
        return c / np.linalg.norm(c)

    cos = float(center(res.Tc_c2b) @ center(gt))
    print(f"[search] global_search_init at its defaults on frame 0: {dt:.3f} s, "
          f"{res.scores.size} candidates, best IoU {res.score:.4f} (best sweep score "
          f"{res.scores.max():.4f}); launches {json.dumps(launches)}; share of scoring "
          f"tiles at cap {res.tiles_at_cap:.4f}; view direction cos to GT {cos:.4f} (the "
          f"JAX package's own search test asks > 0.5); pose error {json.dumps(err)}")
    if not (np.isfinite(res.Tc_c2b).all() and 0 < res.score <= 1):
        raise AssertionError("global search gave no finite pose")
    if launches != {"tile_fwd": 48 + 2 + 200 + 1, "tile_bwd": 200}:
        raise AssertionError(f"K5 launches {launches} in the global search")
    return launches


def trainer_search_phase(lp, K, xi, qs, target, steps):
    """run_offline_calibration on the compact route with
    init_method="global_search": the overflow pre-check (one K5f), the
    search (251 K5f, 200 K5b), then calibrate (K2f/K2b)."""
    import tempfile

    import numpy as np
    import torch

    from easyhec_torch.config import Config
    from easyhec_torch.data import CalibBatch
    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops import tile_raster as tr
    from easyhec_torch.trainer import offline

    cfg = Config()
    m, r, s = cfg.model, cfg.render, cfg.solver
    m.urdf_path = str(ROOT / "assets" / "mini_arm.urdf")
    m.use_links = ["base", "upper", "fore"]
    m.H, m.W, m.subdivide_max_edge = H, W, 0.008
    m.init_method = "global_search"
    r.tile_h, r.tile_w, r.capacity, r.rect_y, r.rect_x = TH, TW, 1664, 5, 3
    r.margin, r.cull_backfaces, r.bin_big_k, r.bin_subsort_rows = 2.0, True, 6144, True
    r.compact_chunks = 256
    s.num_epochs, s.max_lr, s.rebin_every = steps, 3e-3, 0
    batch = CalibBatch(
        rgb=np.zeros((B, H, W, 3), np.uint8), masks=target.cpu().numpy(),
        qpos=qs.astype(np.float32), link_poses=lp.cpu().numpy(), K=K.cpu().numpy(),
        Tc_c2b_gt=se3.exp(xi).cpu().numpy(),
    )
    kernels = {"tile_fwd": tr.tile_fwd_cuda, "tile_bwd": tr.tile_bwd_cuda,
               "loss_fwd_compact": prc.loss_fwd_compact_cuda,
               "loss_bwd_compact": prc.loss_bwd_compact_cuda}
    with tempfile.TemporaryDirectory() as tmp:
        cfg.output_dir = tmp
        torch.cuda.synchronize()
        _reset(kernels)
        t0 = time.perf_counter()
        res = offline.run_offline_calibration(cfg, batch=batch, device=DEVICE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        out = Path(tmp)
        want = ["Tc_c2b.txt", "metrics.json", "eval.json", "config.yaml",
                "checkpoints/final.npz", "metrics.jsonl"]
        missing = [f for f in want if not (out / f).is_file()]
        wall = json.loads((out / "checkpoints" / "final.json").read_text())["wall_time_s"]
    print(f"[trainer search] run_offline_calibration, compact route, init_method="
          f"global_search: {dt:.3f} s in all, calibrate {wall:.3f} s for {steps} steps; "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; {res.rebins} rebins; launches "
          f"{json.dumps(launches)}; pose error {json.dumps(res.metrics)}")
    if missing:
        raise AssertionError(f"trainer artifacts missing: {missing}")
    if not (np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]):
        raise AssertionError("trainer loss did not fall")
    # K5f: the pre-check's one launch and the search's 251; K5b: the search's
    if launches["tile_fwd"] != 1 + 251 or launches["tile_bwd"] != 200:
        raise AssertionError(f"K5 launches {launches} in the global-search trainer run")
    if launches["loss_bwd_compact"] < steps:
        raise AssertionError(f"K2 launches {launches} for {steps} steps")
    return launches


def reference_search():
    """A small global search on the card vs the plain CPU path (96×128, 3
    frames, 24×32 scoring renders, 128 candidates, top 4, 20 Adam steps).

    Held to the calibration reference's limits: the sweep's scores as its
    first loss (1e-5), the top-k order where the scores are separated, and
    the refinement's gradient at identical poses (the CPU's top-k
    candidates and its final pose) to 2e-3 of each pose's max|g|. The final poses are printed, not
    held: Adam at the search's lr 2e-2 steps each component by about lr
    whatever its gradient's size (its first step is sign(g)), so a
    component whose gradient is near zero takes a ±lr step on one device
    and the other's step from the first step on, ~7x calibrate's lr."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import downscale_K
    from easyhec_torch.models.pose_init import _scoring_renderer, global_search_init
    from easyhec_torch.render.fused import silhouette_compact

    out, target, scenes = [], None, {}
    ds, k = 4, 4
    for dev in (DEVICE, "cpu"):
        r, lp, K, xi, _ = build_scene(dev, H=96, W=128, B=3, max_edge=0.04, cap=512, nc=32)
        if target is None:  # one target for both runs, rendered on the card
            with torch.no_grad():
                st = r.bin_state(se3.exp(xi), lp, K)
                target = (silhouette_compact(r, se3.exp(xi), K, st) > 0.5).float().cpu().numpy()
        scenes[dev] = (r, lp, K)
        out.append(global_search_init(r, lp.cpu().numpy(), K.cpu().numpy(), target,
                                      radii=(0.8, 1.3), n_dirs=16, n_roll=4, downscale=ds,
                                      topk=k, refine_steps=20))
    a, b = out
    s_err = np.abs(a.scores - b.scores).max()
    order = np.argsort(-b.scores, kind="stable")
    gaps = -np.diff(b.scores[order[: k + 1]])
    same = np.array_equal(np.argsort(-a.scores, kind="stable")[:k], order[:k])
    Hs, Ws = 96 // ds, 128 // ds
    lo = target.reshape(3, Hs, ds, Ws, ds).mean((2, 4))
    poses = np.concatenate([b.poses[order[:k]], b.Tc_c2b[None]])
    dofs = se3.log(torch.from_numpy(poses))

    def grads(dev):  # the refinement's gradient (sum of per-pose mask losses)
        r, lp, K = scenes[dev]
        sr = _scoring_renderer(r, Hs, Ws)
        Ks = torch.tensor(downscale_K(K.cpu().numpy(), ds), device=dev)
        d = dofs.to(dev).clone().requires_grad_()
        sil = sr.silhouette(se3.exp(d)[:, None], lp.expand((d.shape[0],) + lp.shape), Ks)
        loss = ((sil - torch.tensor(lo, device=dev)) ** 2).sum((-2, -1)).mean(-1).sum()
        return torch.autograd.grad(loss, d)[0].cpu().numpy()

    gk, gp = grads(DEVICE), grads("cpu")
    print(f"[reference search] refinement gradients at the CPU's top-{k} and final poses: "
          + np.array2string(gp, precision=3))
    gmax = np.maximum(np.abs(gp).max(axis=1, keepdims=True), 1e-30)
    g_gap = (np.abs(gk - gp) / gmax).max()  # a pose with a zero gradient must stay zero
    d_gap = np.abs(se3.log(torch.from_numpy(a.Tc_c2b)).numpy() - dofs[-1].numpy()).max()
    print(f"[reference search] small global search cuda vs cpu: sweep scores max abs "
          f"{s_err:.3e} (tol 1e-5), top-{k} order equal {same} (smallest gap among the top "
          f"{k + 1} {gaps.min():.3e}); refinement gradient at identical poses "
          f"{g_gap:.3e} of max|g| (tol 2e-3; smallest |g_i|/max|g| "
          f"{(np.abs(gp) / gmax).min():.3e}); final IoU {a.score:.6f} vs {b.score:.6f}, "
          f"final dof max abs {d_gap:.3e} (not held: Adam's sign-like steps at lr 2e-2)")
    if not (np.isfinite(a.Tc_c2b).all() and 0 < a.score <= 1):
        raise AssertionError("the card's global search gave no finite pose")
    if not (s_err <= 1e-5 and g_gap <= 2e-3):
        raise AssertionError("cuda and cpu global searches disagree")
    if gaps.min() > 1e-5 and not same:
        raise AssertionError("the top-k order differs where the scores are separated")


def silhouette_path(renderer, lp, K, xi, target, steps=20):
    """Adam steps on mean Σ(RobotRenderer.silhouette − mask)² through
    autograd: the image-route loss (easyhec_tpu's sharded calibration
    differentiates the silhouette so). Each step re-bins densely (no bin
    state passed), renders with K4f and differentiates with K4b."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.solver.optim import make_optimizer

    opt = make_optimizer("adam", max_lr=3e-3)
    dof = (xi + 0.01).clone()
    state = opt.init(dof)
    kernels = {"sil_fwd": pr.sil_fwd_cuda, "sil_bwd": pr.sil_bwd_cuda}
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        d = dof.detach().requires_grad_(True)
        sil = renderer.silhouette(se3.exp(d), lp, K)
        loss = ((sil - target) ** 2).sum(dim=(-2, -1)).mean()
        (g,) = torch.autograd.grad(loss, d)
        upd, state = opt.update(g, state, dof)
        dof = (dof + upd).detach()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    losses = torch.stack(losses).cpu()
    print(f"[silhouette] {steps} image-loss steps through RobotRenderer.silhouette: "
          f"{dt / steps * 1e3:.3f} ms/step with a dense rebin each; loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}; launches {json.dumps(launches)}")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("silhouette-path loss did not fall")
    if launches != {"sil_fwd": steps, "sil_bwd": steps}:
        raise AssertionError(f"K4 launches {launches} for {steps} steps")
    return launches


def _profile(renderer, lp, K, d0, target, steps, main_rebins, out, tag, fwd_pat, bwd_pat):
    """Replay a ``calibrate`` run (same start, steps and settings, so the
    same rebin rate) under torch.profiler. Reports that run's own device
    busy share (device time over its wall time) and its device time per
    step by part; writes out/profile_<tag>.txt (top ops) and
    out/profile_breakdown_<tag>.json. No chrome trace: at 1000 steps it
    would hold millions of events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from easyhec_torch.models.calib import calibrate

    out.mkdir(parents=True, exist_ok=True)
    build = renderer.bin_state

    def rebin(*a, **kw):
        with record_function("rebin"):
            return build(*a, **kw)

    renderer.bin_state = rebin  # calibrate's bin builds, marked for the trace
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = calibrate(d0, renderer, lp, K, target, num_steps=steps, max_lr=3e-3,
                            rebin_every=0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del renderer.bin_state
    t0 = time.perf_counter()
    us = dict(total=0.0, fwd=0.0, bwd=0.0, rebin=0.0)
    n_ops = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU:
            if ev.name == "rebin":  # the kernels launched inside the range
                us["rebin"] += ev.device_time_total
        elif not getattr(ev, "is_user_annotation", False):
            us["total"] += ev.device_time_total
            n_ops += 1
            if fwd_pat in ev.name:
                us["fwd"] += ev.device_time_total
            elif bwd_pat in ev.name:
                us["bwd"] += ev.device_time_total
    us["other"] = us["total"] - us["fwd"] - us["bwd"] - us["rebin"]
    per_step = {k: v / 1e3 / steps for k, v in us.items()}
    busy = us["total"] / 1e3 / wall_ms
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out / f"profile_{tag}.txt").write_text(table)
    summary = dict(route=tag, steps=steps, rebins=res.rebins, main_path_rebins=main_rebins,
                   wall_ms=wall_ms, device_ms=us["total"] / 1e3, busy_share=busy,
                   device_ops_per_step=n_ops / steps, device_ms_per_step=per_step,
                   device_ms_per_rebin=us["rebin"] / 1e3 / max(res.rebins, 1))
    (out / f"profile_breakdown_{tag}.json").write_text(json.dumps(summary, indent=1))
    print(f"[profile {tag}] replay under torch.profiler: {steps} steps, "
          f"{res.rebins} rebins (unprofiled run {main_rebins}), {wall_ms:.3f} ms wall, "
          f"that is {wall_ms / steps:.3f} ms/step with the profiler on")
    print(f"[profile {tag}] device busy {us['total'] / 1e3:.3f} ms of that run's "
          f"{wall_ms:.3f} ms wall = {busy:.4f}; {n_ops / steps:.1f} device ops per step")
    print(f"[profile {tag}] device ms per step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_step.items())
        + f" (fwd = {fwd_pat}, bwd = {bwd_pat}); {summary['device_ms_per_rebin']:.4f} "
        f"ms per rebin; post-processing {time.perf_counter() - t0:.1f} s")


def reference_check(nc, fused=True):
    """A small calibration on the card vs the plain CPU path, on the compact
    route (nc > 0 chunks), the dense one (nc = 0) or the unfused one
    (fused=False, K5)."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.render.fused import silhouette_compact

    route = "unfused" if not fused else ("compact" if nc else "dense")
    out, scenes, target = [], {}, None
    for dev in (DEVICE, "cpu"):
        r, lp, K, xi, _ = build_scene(dev, H=96, W=128, B=3, max_edge=0.04, cap=512, nc=nc,
                                      fused=fused)
        if target is None:  # one target for both runs, rendered on the card
            with torch.no_grad():
                if nc and fused:
                    st = r.bin_state(se3.exp(xi), lp, K)
                    sil = silhouette_compact(r, se3.exp(xi), K, st)
                else:
                    sil = r.silhouette(se3.exp(xi), lp, K)
            target = (sil > 0.5).float()
        target = target.to(dev)
        scenes[dev] = (r, lp, K, target)
        out.append(calibrate((xi + 0.01).cpu().numpy(), r, lp, K, target,
                             num_steps=30, rebin_every=0))
    a, b = out
    grad_gap = _divergence(a, b, scenes)
    # Tolerances: the first loss is one kernel call on identical inputs
    # (rtol 1e-5, summation order). The gradient at an identical pose is
    # piecewise in the pose (band mask, clamps, first-match arms): one ulp in
    # one pose component moves it by up to ~1.5e-4 of max|g| (printed
    # above), and the two devices round se3.exp, the camera rows and the
    # edge functions (FMA) differently by more than one ulp, so it is held
    # to 2e-3 of max|g|. Along the trajectory Adam steps every component by
    # about lr whatever its size, so a small component's relative gap enters
    # the pose at full step length and compounds: the trace is held to 1e-2
    # of its scale and the final pose to 1e-3.
    first = abs(a.losses[0] - b.losses[0]) / abs(b.losses[0])
    rel = np.abs(a.losses - b.losses).max() / np.abs(b.losses).max()
    ddof = np.abs(a.dof - b.dof).max()
    print(f"[reference {route}] small calibrate cuda vs cpu: first loss rel {first:.3e} "
          f"(tol 1e-5), gradient at identical poses {grad_gap:.3e} of max|g| "
          f"(tol 2e-3), loss trace rel {rel:.3e} (tol 1e-2), dof max abs "
          f"{ddof:.3e} (tol 1e-3), rebins {a.rebins} vs {b.rebins}")
    if not (first <= 1e-5 and grad_gap <= 2e-3 and rel <= 1e-2 and ddof <= 1e-3):
        raise AssertionError(f"cuda and cpu calibrations disagree ({route})")


def _divergence(a, b, scenes) -> float:
    """Where the card's run ``a`` and the CPU's run ``b`` part, and why.

    Evaluates d(loss)/d(dof) on both devices at the CPU run's own poses, so
    the inputs are identical. Prints the first step whose loss differs by
    more than 1e-5 of the trace's scale, the dof component that differs
    most in the pose before it, and that component's gradient size and
    device gap. Returns the largest gradient gap over max|g|."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import mask_loss

    def grad(scene, h):
        r, lp, K, target = scene
        d = torch.tensor(h, device=r.device, requires_grad=True)
        st = r.bin_state(se3.exp(d.detach()), lp, K)
        (g,) = torch.autograd.grad(mask_loss(d, r, lp, K, target, bin_state=st), d)
        return g.cpu().numpy()

    grads = {dev: np.stack([grad(s, h) for h in b.history]) for dev, s in scenes.items()}
    gc, gp = grads[DEVICE], grads["cpu"]
    gmax = np.abs(gp).max(axis=1, keepdims=True)
    # Rounding sensitivity of the loss surface itself: the CPU gradient at
    # the first pose with one pose component moved by one ulp.
    h0 = b.history[0].astype(np.float32)
    ulp = []
    for i in range(6):
        h = h0.copy()
        h[i] = np.nextafter(h[i], np.float32(np.inf))
        ulp.append(np.abs(grad(scenes["cpu"], h) - gp[0]).max() / gmax[0, 0])
    print("[reference] one ulp in one pose component moves the CPU gradient by "
          f"up to {max(ulp):.3e} of max|g| (per component: "
          + np.array2string(np.array(ulp), precision=3) + ")")
    gap = np.abs(gc - gp) / gmax  # [steps, 6], relative to each step's max|g|
    comp_rel = np.abs(gc - gp) / np.maximum(np.abs(gp), 1e-30)  # per component
    dl = np.abs(a.losses - b.losses) / np.abs(b.losses).max()
    parted = np.flatnonzero(dl > 1e-5)
    if parted.size:
        k = int(parted[0])
        j = int(np.argmax(np.abs(a.history[k] - b.history[k])))
        print(f"[reference] the loss traces part at step {k} (rel {dl[k]:.3e}); the "
              f"pose before it differs most in dof[{j}] by "
              f"{abs(a.history[k, j] - b.history[k, j]):.3e}")
        print(f"[reference] over steps 0..{k - 1}, at identical poses: |g[{j}]|/max|g| "
              f"min {(np.abs(gp[:k, j]) / gmax[:k, 0]).min() if k else 0:.3e}; "
              f"g[{j}] device gap, relative to g[{j}], up to "
              f"{comp_rel[:k, j].max() if k else 0:.3e}")
    print("[reference] at identical poses, per dof component: |g|/max|g| min "
          + np.array2string(np.abs(gp / gmax).min(axis=0), precision=3)
          + "; device gap relative to the component, max "
          + np.array2string(comp_rel.max(axis=0), precision=3))
    return float(gap.max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="replay the compact and the dense calibrate runs under "
                         "torch.profiler and write their summaries into DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        import easyhec_torch  # noqa: F401
        from easyhec_torch.ops import _build
    except ImportError as e:
        return _fail(f"easyhec_torch not importable ({e}): run from a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[build] {sorted(secs)} built in {time.perf_counter() - t0:.2f} s")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
    gpu = _gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops import tile_raster as tr
    from easyhec_torch.render import RobotRenderer
    from easyhec_torch.render.fused import silhouette_compact

    renderer, lp, K, xi, qs = build_scene(DEVICE)
    print(f"[scene] {renderer.n_faces} triangles, {B} frames of {W}x{H}")
    st_gt = renderer.bin_state(se3.exp(xi), lp, K)
    if bool(st_gt.overflow):
        raise AssertionError("bin overflow at the ground-truth pose")
    target = (silhouette_compact(renderer, se3.exp(xi), K, st_gt) > 0.5).float()
    print(f"[scene] target masks: {float(target.mean()):.4f} of pixels set; GT-pose "
          f"loads max tile {int(st_gt.counts.max())}, max ncu {int(st_gt.ncu.max())}")
    dense = RobotRenderer(renderer.meshes, H, W,
                          tile=renderer.tile._replace(compact_chunks=0), device=DEVICE)
    with torch.no_grad():  # RobotRenderer.silhouette (K4f) at the GT pose
        target_d = (dense.silhouette(se3.exp(xi), lp, K) > 0.5).float()
    print(f"[scene] dense target masks: {float(target_d.mean()):.4f} of pixels set, "
          f"{float((target_d != target).float().mean()):.2e} differ from the compact ones")

    unfused = RobotRenderer(renderer.meshes, H, W, device=DEVICE,
                            tile=renderer.tile._replace(fused=False, compact_chunks=0))
    with torch.no_grad():  # RobotRenderer.silhouette on the unfused route (K5f)
        target_u = (unfused.silhouette(se3.exp(xi), lp, K) > 0.5).float()
    print(f"[scene] unfused target masks: {float(target_u.mean()):.4f} of pixels set, "
          f"{float((target_u != target_d).float().mean()):.2e} differ from the dense ones")

    check_tile_acc(renderer, K, xi, st_gt)
    kernels = kernel_phase(renderer, lp, K, xi, target)
    kernels += dense_kernel_phase(dense, lp, K, xi, target_d)
    kernels += unfused_kernel_phase(unfused, lp, K, xi, target_u)
    large_tile_phase()

    compact_k = {"loss_fwd_compact": prc.loss_fwd_compact_cuda,
                 "loss_bwd_compact": prc.loss_bwd_compact_cuda}
    launches, ms_c, rebins_c = main_path(renderer, lp, K, xi, target, args.steps,
                                         compact_k, "main compact")
    _, ms_d, rebins_d = main_path(dense, lp, K, xi, target_d, args.steps,
                                  {"loss_fwd": pr.loss_fwd_cuda, "loss_bwd": pr.loss_bwd_cuda},
                                  "main dense")
    unf_launches, ms_u, rebins_u = main_path(unfused, lp, K, xi, target_u, args.steps,
                                      {"tile_fwd": tr.tile_fwd_cuda,
                                       "tile_bwd": tr.tile_bwd_cuda}, "main unfused")
    if unf_launches != {"tile_fwd": args.steps, "tile_bwd": args.steps}:
        raise AssertionError(f"K5 launches {unf_launches}: not one K5f and one K5b per step")
    launches.update(unf_launches)
    print(f"[main] dense and unfused against compact, same call: {ms_d:.3f} and {ms_u:.3f} "
          f"against {ms_c:.3f} ms/step ({ms_d / ms_c:.3f}x, {ms_u / ms_c:.3f}x)")
    if args.profile:
        d0 = (xi + 0.01).cpu().numpy()
        _profile(renderer, lp, K, d0, target, args.steps, rebins_c, Path(args.profile),
                 "compact", "loss_fwd_compact_kernel", "loss_bwd_compact_kernel")
        _profile(dense, lp, K, d0, target_d, args.steps, rebins_d, Path(args.profile),
                 "dense", "pose_fwd_kernel<true>", "pose_bwd_kernel<true>")
        _profile(unfused, lp, K, d0, target_u, args.steps, rebins_u, Path(args.profile),
                 "unfused", "tile_fwd_kernel", "tile_bwd_kernel")
    trainer_launches, _ = trainer_phase(lp, K, xi, qs, target_d, args.steps)
    sil_launches = silhouette_path(dense, lp, K, xi, target_d)
    launches.update({k: trainer_launches[k] for k in ("loss_fwd", "loss_bwd", "sil_fwd")})
    launches["sil_bwd"] = sil_launches["sil_bwd"]
    search_phase(renderer, lp, K, xi, target)
    trainer_search_phase(lp, K, xi, qs, target, args.steps)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    reference_check(32)
    reference_check(0)
    reference_check(0, fused=False)
    reference_search()

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: d[k] for k in order} for d in kernels]}))
    print(gpu)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
