#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (easyhec_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--profile DIR]

Run from the root of a checkout; it imports nothing of JAX or easyhec_tpu.
Phases, in order (any failure exits non-zero):

1. Build: compile every CUDA kernel of easyhec_torch/ops/csrc with nvcc
   (sm_90a), print the build seconds and the card's name and power limit.
2. Kernel vs plain, at the main path's full shapes on a real bin state:
   the compact loss forward (per-frame loss, min(acc, 2)) and backward
   (dcam) against their plain PyTorch versions.
3. Main path: ``calibrate`` on the bench workload — 10 frames of 640x480,
   f = 600, the procedural arm (assets/mini_arm.urdf subdivided to 8 mm
   edges, 21,312 triangles), compact fused tiles (16x32, cap 1664, 256
   chunks), adaptive rebinning, Adam 3e-3 from xi + 0.01, target masks
   rendered by the forward kernel at the ground-truth pose. Asserts no
   overflow, a falling loss, and launch counts that show every step went
   through both kernels.
4. Reference check on a small input: the same calibration at a small size
   on the card and through the plain versions on the CPU must agree.

Prints the kernel table as one JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. With --profile DIR it
also replays the main path under torch.profiler and writes that run's
device busy share and per-step breakdown into DIR.
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


def build_scene(device, H=H, W=W, B=B, max_edge=0.008, cap=1664, nc=256):
    """The bench workload's scene on `device`: (renderer, lp, K, xi_gt)."""
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
        tile_h=TH, tile_w=TW, capacity=cap, binner="count", rect_y=5, rect_x=3,
        margin=2.0, cull_backfaces=True, fused=True, bwd_band_only=True,
        bin_big_k=6144, bin_subsort_rows=True, compact_chunks=nc, bwd_chunks=0,
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
    return renderer, lp, K, xi


def _needed_work(cam, st, ref_tiles, acc, gb, meta):
    """(fwd pairs, fwd lanes, bwd pairs, bwd lanes, fwd bytes, bwd bytes)
    that THIS call's data needs: chunks the saturation early-out skips and
    backward chunks with no live pixel are not counted."""
    import torch

    from easyhec_torch.ops.pose_raster import (
        _chunk_coverage, _chunk_setup, pix_grids, tile_origin,
    )
    from easyhec_torch.ops.pose_raster_compact import _chunks_of, _cotangent

    P = meta.th * meta.tw
    px, py = pix_grids(meta.th, meta.tw, cam.device)
    Bn, nc = st.nlive.shape
    T = ref_tiles.shape[1]
    fp = fl = bp = bl = 0
    fbytes = Bn * T * P * 4 + Bn * T * 4 + Bn * (nc * 8 + 4 + 64)
    bbytes = Bn * (nc * 12 + 4 + 64) + Bn * nc * 48
    for b in range(Bn):
        ct = st.ctmap[b].long()
        x0, y0 = tile_origin(ct, meta.n_tx, meta.th, meta.tw)
        blk = _chunks_of(st.rec[b])
        s = _chunk_setup(blk, cam[b].expand(nc, 16), x0, y0, meta.near, meta.far)
        cov, *_ = _chunk_coverage(s, px, py, meta.sharpness)
        nl = st.nlive[b].long()
        delta = cov.sum(dim=-2) * (nl > 0)[:, None]
        cs = torch.cumsum(delta, dim=0)
        first = torch.ones(nc, dtype=torch.bool, device=cam.device)
        first[1:] = ct[1:] != ct[:-1]
        start = torch.cummax(torch.where(first, torch.arange(nc, device=cam.device), 0), 0)[0]
        base = torch.where((start > 0)[:, None], cs[(start - 1).clamp(min=0)], 0.0)
        before = cs - delta - base
        run = (nl > 0) & ~(before.amin(dim=-1) >= 2.0)
        fp += int((nl * run).sum()) * P
        fl += int((nl * run).sum())
        fbytes += int(run.sum()) * CHUNK_BYTES + int(first.sum()) * P * 4
        gp = _cotangent(acc[b].reshape(T, P)[ct], ref_tiles[b].reshape(T, P)[ct],
                        gb[b], ct, meta)
        live_px = (gp != 0).sum(dim=-1)
        live = (nl > 0) & (live_px > 0)
        nvalid = (s["valid"] & (torch.arange(128, device=cam.device) < nl[:, None])).sum(-1)
        bp += int((nvalid * live_px * live).sum())
        bl += int((nvalid * live).sum())
        bbytes += int(live.sum()) * (CHUNK_BYTES + 2 * P * 4)
    return fp, fl, bp, bl, fbytes, bbytes


def kernel_phase(renderer, lp, K, xi, target):
    """Phase 2: both kernels against their plain versions at full shapes.
    Returns the per-kernel measurements."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import tile_masks
    from easyhec_torch.ops import pose_raster_compact as prc
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
    lk, acck = prc.loss_fwd_compact_cuda(*fargs)
    lp_, accp = prc.loss_fwd_compact_plain(*fargs)
    torch.cuda.synchronize()
    fk, fpl = lk.sum(-1), lp_.sum(-1)
    loss_err = (lk - lp_).abs().max().item()
    frame_rel = ((fk - fpl).abs() / fpl.abs().clamp(min=1e-6)).max().item()
    acc_err = (acck.clamp(max=2) - accp.clamp(max=2)).abs().max().item()
    # Tolerances: the per-frame loss sums 512 pixels x ~600 tiles in another
    # order (rtol 1e-4). acc sums up to ~1,300 lane coverages per pixel, and
    # nvcc contracts each edge function a*px + b*py + c into FMAs, which
    # rounds differently by ~1e-6 per term (|c| is up to the tile size):
    # atol 1e-3 on min(acc, 2).
    print(f"[kernels] K2f loss: max abs err per tile {loss_err:.3e}, per frame "
          f"rel {frame_rel:.3e} (tol rtol 1e-4); min(acc,2) max abs err "
          f"{acc_err:.3e} (tol 1e-3). Reason: summation order over lanes, "
          "pixels and tiles; FMA contraction of the edge functions")
    if not (frame_rel <= 1e-4 and acc_err <= 1e-3):
        raise AssertionError("K2f disagrees with its plain version")

    gb = torch.full((B,), 1.0 / B, device=cam.device)
    bargs = (cam, st.rec, st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref, acck, gb, meta)
    dk = prc.loss_bwd_compact_cuda(*bargs).sum(1)
    dpl = prc.loss_bwd_compact_plain(*bargs).sum(1)
    torch.cuda.synchronize()
    scale = dpl.abs().max().item()
    dcam_err = (dk - dpl).abs().max().item()
    print(f"[kernels] K2b dcam: max abs err {dcam_err:.3e}, max|dcam| {scale:.3e} "
          f"(tol 1e-3*max|dcam|). Reason: summation order over lanes and pixels")
    if not (scale > 0 and dcam_err <= 1e-3 * scale):
        raise AssertionError("K2b disagrees with its plain version")

    fwd_ms = _time_ms(lambda: prc.loss_fwd_compact_cuda(*fargs), 50)
    bwd_ms = _time_ms(lambda: prc.loss_bwd_compact_cuda(*bargs), 50)
    fwd_plain_ms = _time_ms(lambda: prc.loss_fwd_compact_plain(*fargs), 3, warm=1)
    bwd_plain_ms = _time_ms(lambda: prc.loss_bwd_compact_plain(*bargs), 3, warm=1)
    fp, fl, bp, bl, fbytes, bbytes = _needed_work(cam, st, ref, acck, gb, meta)
    fwd_ops = fp * OPS_FWD_PAIR + fl * OPS_FWD_LANE
    bwd_ops = bp * OPS_BWD_PAIR + bl * OPS_BWD_LANE

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    fb, fby = bound(fbytes, fwd_ops)
    bb, bby = bound(bbytes, bwd_ops)
    print(f"[kernels] K2f {fwd_ms:.4f} ms (plain {fwd_plain_ms:.3f} ms), needs "
          f"{fp} lane-pixel pairs, {fbytes} bytes -> bound {fb:.4f} ms ({fby})")
    print(f"[kernels] K2b {bwd_ms:.4f} ms (plain {bwd_plain_ms:.3f} ms), needs "
          f"{bp} live lane-pixel pairs, {bbytes} bytes -> bound {bb:.4f} ms ({bby})")
    print(f"[kernels] start-pose loads: max tile count {int(st.counts.max())} "
          f"(cap {cfg.capacity}), max ncu {int(st.ncu.max())} (budget {cfg.compact_chunks})")
    src = "easyhec_torch/ops/csrc/pose_raster_compact.cu"
    return [
        dict(name="loss_fwd_compact", route="cuda", source=src,
             replaces="easyhec_tpu/ops/pose_raster_compact.py:66",
             max_abs_err=loss_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
             bound_ms=fb, bound_by=fby, library_ms=None),
        dict(name="loss_bwd_compact", route="cuda", source=src,
             replaces="easyhec_tpu/ops/pose_raster_compact.py:105",
             max_abs_err=dcam_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
             bound_ms=bb, bound_by=bby, library_ms=None),
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


def main_path(renderer, lp, K, xi, target, steps, profile_dir):
    """Phase 3: the port's calibrate at full width."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.ops import pose_raster_compact as prc

    d0 = (xi + 0.01).cpu().numpy()
    gt = se3.exp(xi).cpu().numpy()
    torch.cuda.synchronize()
    prc.loss_fwd_compact_cuda.launches = 0
    prc.loss_bwd_compact_cuda.launches = 0
    t0 = time.perf_counter()
    res = calibrate(d0, renderer, lp, K, target, num_steps=steps, max_lr=3e-3,
                    rebin_every=0, Tc_c2b_gt=gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nf, nb = prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches
    print(f"[main] {steps} steps in {dt:.3f} s: {dt / steps * 1e3:.3f} ms/step, "
          f"{steps * B * H * W / dt:.0f} px/s fwd+bwd, {res.rebins} rebins")
    print(f"[main] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; launches "
          f"K2f {nf}, K2b {nb}; pose error {json.dumps(res.metrics)}")
    if res.overflow:
        raise AssertionError("bin overflow during calibrate")
    if not (np.isfinite(res.losses).all() and np.isfinite(res.dof).all()):
        raise AssertionError("non-finite loss or pose")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError("loss did not fall")
    if nf < steps or nb != steps:
        raise AssertionError(f"launch counts K2f {nf}, K2b {nb} for {steps} steps")
    if profile_dir:
        _profile(renderer, lp, K, d0, target, steps, res.rebins, Path(profile_dir))
    return {"loss_fwd_compact": nf, "loss_bwd_compact": nb}


def _profile(renderer, lp, K, d0, target, steps, main_rebins, out):
    """Replay the main path (same start, steps and settings, so the same
    rebin rate) under torch.profiler. Reports that run's own device busy
    share (device time over its wall time) and its device time per step by
    part; writes out/profile_calibrate.txt (top ops) and
    out/profile_breakdown.json. No chrome trace: at 1000 steps it would hold
    millions of events."""
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
    us = dict(total=0.0, k2f=0.0, k2b=0.0, rebin=0.0)
    n_ops = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU:
            if ev.name == "rebin":  # the kernels launched inside the range
                us["rebin"] += ev.device_time_total
        elif not getattr(ev, "is_user_annotation", False):
            us["total"] += ev.device_time_total
            n_ops += 1
            if "loss_fwd_compact_kernel" in ev.name:
                us["k2f"] += ev.device_time_total
            elif "loss_bwd_compact_kernel" in ev.name:
                us["k2b"] += ev.device_time_total
    us["other"] = us["total"] - us["k2f"] - us["k2b"] - us["rebin"]
    per_step = {k: v / 1e3 / steps for k, v in us.items()}
    busy = us["total"] / 1e3 / wall_ms
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out / "profile_calibrate.txt").write_text(table)
    summary = dict(steps=steps, rebins=res.rebins, main_path_rebins=main_rebins,
                   wall_ms=wall_ms, device_ms=us["total"] / 1e3, busy_share=busy,
                   device_ops_per_step=n_ops / steps, device_ms_per_step=per_step,
                   device_ms_per_rebin=us["rebin"] / 1e3 / max(res.rebins, 1))
    (out / "profile_breakdown.json").write_text(json.dumps(summary, indent=1))
    print(f"[profile] replay of the main path under torch.profiler: {steps} steps, "
          f"{res.rebins} rebins (main path {main_rebins}), {wall_ms:.3f} ms wall, "
          f"that is {wall_ms / steps:.3f} ms/step with the profiler on")
    print(f"[profile] device busy {us['total'] / 1e3:.3f} ms of that run's "
          f"{wall_ms:.3f} ms wall = {busy:.4f}; {n_ops / steps:.1f} device ops per step")
    print("[profile] device ms per step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_step.items())
        + f"; {summary['device_ms_per_rebin']:.4f} ms per rebin; post-processing "
        f"{time.perf_counter() - t0:.1f} s")


def reference_check():
    """Phase 4: a small calibration on the card vs the plain CPU path."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.render.fused import silhouette_compact

    out, scenes, target = [], {}, None
    for dev in ("cuda", "cpu"):
        r, lp, K, xi = build_scene(dev, H=96, W=128, B=3, max_edge=0.04, cap=512, nc=32)
        if target is None:  # one target for both runs, rendered on the card
            st = r.bin_state(se3.exp(xi), lp, K)
            target = (silhouette_compact(r, se3.exp(xi), K, st) > 0.5).float()
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
    print(f"[reference] small calibrate cuda vs cpu: first loss rel {first:.3e} "
          f"(tol 1e-5), gradient at identical poses {grad_gap:.3e} of max|g| "
          f"(tol 2e-3), loss trace rel {rel:.3e} (tol 1e-2), dof max abs "
          f"{ddof:.3e} (tol 1e-3), rebins {a.rebins} vs {b.rebins}")
    if not (first <= 1e-5 and grad_gap <= 2e-3 and rel <= 1e-2 and ddof <= 1e-3):
        raise AssertionError("cuda and cpu calibrations disagree")


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
    gc, gp = grads["cuda"], grads["cpu"]
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
                    help="replay the main path under torch.profiler and write "
                         "its summary into DIR")
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
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    gpu = _gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from easyhec_torch.geometry import se3
    from easyhec_torch.render.fused import silhouette_compact

    renderer, lp, K, xi = build_scene("cuda")
    print(f"[scene] {renderer.n_faces} triangles, {B} frames of {W}x{H}")
    st_gt = renderer.bin_state(se3.exp(xi), lp, K)
    if bool(st_gt.overflow):
        raise AssertionError("bin overflow at the ground-truth pose")
    target = (silhouette_compact(renderer, se3.exp(xi), K, st_gt) > 0.5).float()
    print(f"[scene] target masks: {float(target.mean()):.4f} of pixels set; GT-pose "
          f"loads max tile {int(st_gt.counts.max())}, max ncu {int(st_gt.ncu.max())}")

    check_tile_acc(renderer, K, xi, st_gt)
    kernels = kernel_phase(renderer, lp, K, xi, target)
    launches = main_path(renderer, lp, K, xi, target, args.steps, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    reference_check()

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
