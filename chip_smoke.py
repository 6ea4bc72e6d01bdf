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
through the record pack, K5f and the counted K5b in one autograd Function,
then autograd through the triangle setup).
Phases, in order (any failure exits non-zero):

1. Build: compile every CUDA kernel of easyhec_torch/ops/csrc with nvcc
   (sm_90a), one nvcc per source started together; print the build seconds
   and the card's name and power limit.
2. Kernels vs plain, at the full shapes on real bin states: the compact
   loss forward and backward (K2); the dense loss (K1) and silhouette (K4)
   forward and backward, K4b also through autograd on
   RobotRenderer.silhouette; the unfused rasterizer K5f (image, min(acc, 2)),
   the dense K5b (dtri) and the counted K5b (dfields through the gather at
   q, and dTc through autograd on RobotRenderer.silhouette); K2b on the
   boundary-prefix backward map (bwd_chunks > 0) against the full map.
   Each kernel's CUDA-event time (device time: the calls are queued behind
   a device sleep), its plain version's, its bound for this data (only the
   lane-pixel pairs in each lane's band-dilated bbox, the whole-tile count
   printed beside it, and the records of the live slots), and its
   registers, stack and spill bytes from nvcc's -Xptxas -v log (the six
   fused kernels and the three K5 kernels must not spill). They run twice
   on the same inputs and must repeat bit for bit; the forwards' min(acc,
   2), K5f's too, is compared bit for bit with the plain version's
   slot-order sum (printed).
   K3 (compact_tile_acc) is checked at the GT pose. Then K1, K2 (with K3)
   and K4 on 32x128 tiles (the forwards in 16 regions of 8x32 pixels per
   tile, the backwards over one 4096-pixel live list) against their plain
   versions.
3. Main paths: ``calibrate`` at the bench scene on the compact, dense and
   unfused routes, 1000 steps each. Asserts no overflow, a falling loss, and
   one loss (or K5f and counted K5b) kernel pair launch per step.
4. Dense trainer: ``run_offline_calibration`` with an in-memory Config and
   CalibBatch. Asserts no overflow, a falling loss, one K1f and one K1b
   launch per step, one K4f launch per render_outputs call, the artifacts.
5. Silhouette gradient paths: Adam steps on Σ(RobotRenderer.silhouette −
   mask)² through autograd: one K4f and one K4b launch per step on the
   dense route; one K5f and one dense K5b per step on the unfused route's
   top-k binner (binner="topk").
6. Global search: ``global_search_init`` at its defaults on frame 0 (K5f
   251 launches, the counted K5b 200), then K5f and both K5b timed against
   their plain versions at its sweep and refinement batches; then
   ``run_offline_calibration`` on the compact route with
   init_method="global_search" (the overflow pre-check adds one K5f).
7. The online loop: ``run_iterative`` as a simulated closed loop at
   configs/xarm7_example.yaml's widths (1280x720, f = 906.8, its render,
   solver and explorer settings, 5 rounds) on the mini arm: per round the
   frames, loss, pose error, the seconds of capture, calibrate, explore
   and plan, the explorer's statistics and the launches of K2f, K2b, K3
   and K4f. Asserts the final error under 1.5 cm and 1.5 deg and K3's
   launches per scoring pass. Then K3 at the explorer's scoring shape (5
   frames of 640x360) against its plain version, with one scoring pair's
   CUDA-event time (host-paced), host time and device busy time (the
   profiler's sum of its device ops).
8. The remaining options and offline tools. ``[schedules]``: the compact
   route's calibrate under warmup_cosine (100 warmup steps), its lr at
   four steps against the closed form, one K2f/K2b pair per step.
   ``[brute]`` and ``[xla tiled 80x60]``: RobotRenderer(mode="brute") and a
   use_pallas=False renderer (no kernel) on the bench arm at 80x60, 4
   frames: their silhouettes against K5f's at the same pose, their pose
   gradient against the compact route's, 20 calibrate steps each, and no
   kernel launch on either. ``[xla tiled]``: the use_pallas=False route at
   the bench scene (10 frames of 640x480, the bench tile config without
   culling, which that route skips, at the unculled peak load's capacity;
   whether the bench's cap 1664 overflows there is printed): its silhouette
   against K5f's and its gradient against the counted K5b's at that
   capacity, 2 calibrate steps, no kernel launch. ``[ring]``:
   generate_pose_dataset at 640x480, 8 views (one K4f). ``[validate]``: the validate tool on the trainer
   run's checkpoint (one K4f). ``[tune_init]``: the tune_init tool's
   global search on frame 0 (K5f and the counted K5b). ``[pnp]``:
   ransac_pnp with 256 hypotheses on projected mesh vertices (0.5 px
   noise, 30 % outliers), card against CPU.
9. Perception and the remaining tools. ``[segmenter]``:
   ``cli.train_segmenter.train`` with an in-memory Config at
   configs/xarm7_example.yaml's widths (1280x720, f = 1.2·1280, 6 ring
   cameras × 8 frames, 600 steps of batch 4, base 16): the data's seconds
   and K4f launches, ms/step beside the step's FP32 FLOP bound, peak
   memory, JAX's floors (final loss < 0.25, val IoU mean > 0.6, min >
   0.5), and the U-Net's logits on one frame card against CPU; then K4f at
   1280x720 against its plain version (its kernels row). ``[seg closed
   loop]``: 5 held-out frames, masks predicted on the card, ``calibrate``
   (compact route, 1000 steps) on them from a perturbed GT within 2 cm and
   2 deg, one K2f/K2b pair per step. ``[annotate]``: cli/annotate --auto,
   then --box/--point, on the held-out frames written as PNGs; the masks
   read back equal the segmenter's bit for bit. ``[diagnose]``: the
   diagnose tool on the trainer's batch with frames 2 and 5's qposes
   swapped (baseline, robust, --repair re-pairs exactly those two).
   ``[lr_finder]``: find_lr over the compact loss on one bin state, 100
   Adam steps, one K2f/K2b pair a step. ``[profiling]``: EvalTimer with a
   CUDA sync and a torch.profiler trace of 5 calibrate steps. ``[watch]``:
   utils.live.serve answering /api/ls on the trainer's run dir.
10. Reference checks on small inputs, compact, dense and unfused, a small
   global search and a small explorer scoring pass: the card against the
   plain versions on the CPU.

Prints the kernel table as one JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. With --profile DIR it
also replays the compact, the dense and the unfused ``calibrate`` runs
under torch.profiler and writes each run's device busy share and per-step
breakdown into DIR.
"""
from __future__ import annotations

import argparse
import copy
import json
import re
import shutil
import subprocess
import sys
import tempfile
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
SLOT_BYTES = 12 * 4  # one record slot of the fused kernels (12 fields)
K5_SLOT_BYTES = 13 * 4  # the 13 fields of a K5 record slot that K5 reads
GPU = ""  # the card's name and power limit (nvidia-smi), printed beside each time


def _busy_ms(fn, reps: int) -> float:
    """Mean device busy time of fn over reps calls: the summed device time of
    the ops torch.profiler records, whatever pace the host sets."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.events()
             if ev.device_type != DeviceType.CPU
             and not getattr(ev, "is_user_annotation", False))
    return us / 1e3 / reps


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
    """Mean device time of fn over reps calls, by CUDA events. A device-side
    sleep of ~10 ms goes first, so the host queues the calls while the card
    waits and the events read the card's time, not the wrapper's Python
    overhead (which exceeds a fast kernel's time); a call that synchronizes
    the host inside is paced by the host all the same."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # clock cycles
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
    its lane is a live slot whose coverage can be nonzero at the pixel: the
    pixel centre lies in the lane's bbox dilated by the soft band
    0.5/sharpness (band_mask; every other pair has exactly zero coverage),
    and, for a backward, the pixel's cotangent is live. The same pairs under
    the earlier whole-tile rule (every pixel of the tile, or every live
    pixel, for each lane whose band-dilated bbox reaches the tile) are kept
    beside them. Lanes are the live slots set up: the records a kernel must
    read (SLOT_BYTES each). Forward chunks that the
    saturation early-out skips, and backward chunks with no live cotangent
    pixel, are not counted. A tile is visited when it has a live slot: the
    backward needs acc and ref (or g) of visited tiles only, since the parts
    of the others are zero. Returns {"fwd": [pairs, lanes, chunks,
    whole-tile pairs], name: [...], "tiles": visited tiles, "heavy": [lanes
    reaching it, forward pairs] of the tile with the most such lanes}."""
    import torch

    from easyhec_torch.ops.pose_raster import (
        CHUNK, _chunk_coverage, _chunk_setup, band_mask, pix_grids, tile_origin,
    )

    dev = cam.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    reach = 0.5 / meta.sharpness + 1.0
    work = {"fwd": [0, 0, 0, 0], "tiles": 0, "heavy": [0, 0],
            **{k: [0, 0, 0, 0] for k in gps}}
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
        band = band_mask(s, px, py, meta.sharpness) & live_slot[..., None]  # [n, C, P]
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
        fwd_pairs = band.sum(dim=(-2, -1))
        # (chunks run, pairs, whole-tile pairs)
        uses = {"fwd": (run, fwd_pairs, nok * meta.th * meta.tw)}
        for k, gp in gps.items():
            live = gp[b][ct] != 0  # [n, P]
            live_px = live.sum(dim=-1)
            uses[k] = ((nl > 0) & (live_px > 0), (band & live[:, None, :]).sum(dim=(-2, -1)),
                       nok * live_px)
        for k, (use, pairs, tile_pairs) in uses.items():
            w = work[k]
            w[0] += int((pairs * use).sum())
            w[1] += int((nslot * use).sum())
            w[2] += int(use.sum())
            w[3] += int((tile_pairs * use).sum())
        work["tiles"] += int(torch.unique(ct[nl > 0]).numel())
        T = int(ct.max()) + 1
        lanes_t = torch.zeros(T, dtype=torch.long, device=dev).index_add_(0, ct, nok)
        pairs_t = torch.zeros(T, dtype=torch.long, device=dev).index_add_(0, ct, fwd_pairs)
        h = int(torch.argmax(lanes_t))
        if int(lanes_t[h]) > work["heavy"][0]:
            work["heavy"] = [int(lanes_t[h]), int(pairs_t[h])]
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
    # order (rtol 1e-4). acc sums up to ~1,300 lane coverages per pixel in
    # slot order, the plain version over each chunk's lanes first: atol 1e-3
    # on min(acc, 2).
    print(f"[kernels] {tag} loss: max abs err per tile {err:.3e}, per frame rel "
          f"{frame_rel:.3e} (tol rtol 1e-4); min(acc,2) max abs err {acc_err:.3e} "
          "(tol 1e-3). Reason: summation order over lanes, pixels and tiles")
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


def _ptxas(source, kernel):
    """{regs, stack, spill_st, spill_ld} of the entry function whose mangled
    name holds `kernel`, from the -Xptxas -v log of csrc/<source>.cu."""
    from easyhec_torch.ops import _build

    info, cur = {}, None
    for line in _build.build_log(source).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = info.setdefault(m.group(1), {})
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                       spill_ld=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["regs"] = int(m.group(1))
    hits = [v for k, v in info.items() if kernel in k]
    if len(hits) != 1 or len(hits[0]) != 4:
        raise AssertionError(f"no single ptxas report for {kernel} in {source}.cu")
    return hits[0]


def _check_repeat(tag, run):
    """Two launches of a kernel on the same inputs: bit-identical outputs
    (fixed-order sums, no atomics); run returns one tensor."""
    import torch

    a, b = run(), run()
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    print(f"[kernels] {tag} twice on the same inputs: bit-identical {same}")
    if not same:
        raise AssertionError(f"{tag} is not deterministic")


def _fwd_out(out):
    """A forward's (per-tile loss or image, acc) as one tensor, acc clamped
    at 2 (acc >= 2 is unspecified): what two launches must repeat."""
    import torch

    return torch.cat([out[0].flatten(), out[1].clamp(max=2).flatten()])


def _lane_order_acc(cam, frames, meta, T):
    """The plain version's coverage summed lane after lane, in slot order
    per tile (the order of the forward kernels' sums), each pair through
    _chunk_setup and _chunk_coverage: [B, T, th, tw]. frames as for
    _needed_work."""
    import torch

    from easyhec_torch.ops.pose_raster import CHUNK, _chunk_coverage, _chunk_setup, \
        pix_grids, tile_origin

    B, P = len(frames), meta.th * meta.tw
    dev = cam.device
    px, py = pix_grids(meta.th, meta.tw, dev)
    acc = torch.zeros((B * T, P), dtype=torch.float32, device=dev)
    for b, (blk, ct, nl) in enumerate(frames):
        keep = nl > 0
        blk, ct, nl = blk[keep], ct[keep], nl[keep]
        n = ct.numel()
        if n == 0:
            continue
        x0, y0 = tile_origin(ct, meta.n_tx, meta.th, meta.tw)
        s = _chunk_setup(blk, cam[b].expand(n, 16), x0, y0, meta.near, meta.far)
        cov, *_ = _chunk_coverage(s, px, py, meta.sharpness)  # [n, C, P]
        cov = cov * (torch.arange(CHUNK, device=dev) < nl[:, None])[..., None]
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = ct[1:] != ct[:-1]
        ar = torch.arange(n, device=dev)
        j = ar - torch.cummax(torch.where(first, ar, 0), 0)[0]  # chunk index in its tile
        for jj in range(int(j.max()) + 1):
            sel = j == jj
            rows, cj = b * T + ct[sel], cov[sel]
            for lane in range(CHUNK):
                acc[rows] = acc[rows] + cj[:, lane]
    return acc.reshape(B, T, meta.th, meta.tw)


def _check_lane_order(tag, acc_k, acc_lo):
    """Whether min(acc, 2) of a forward kernel equals, bit for bit, the
    plain version's slot-order sum (printed, not held: it holds if every
    skipped pair is an exact zero and every kept pair rounds as the plain
    version's ops do)."""
    import torch

    torch.cuda.synchronize()
    a, b = acc_k.clamp(max=2), acc_lo.clamp(max=2)
    same = torch.equal(a, b)
    print(f"[kernels] {tag} min(acc, 2) bit-identical to the plain version's slot-order "
          f"sum: {same} (max abs diff {(a - b).abs().max().item():.3e})")


def _row(name, tag, source, replaces, err, run, plain, nbytes, ops, kernel,
         spill_free=False):
    """Time a kernel (CUDA events, mean of 50 launches) and its plain
    version (3), bound its work, print them with the kernel's ptxas report
    (`kernel`: a piece of its mangled name) and return its kernels-line row.
    spill_free: fail unless ptxas reports no stack frame and no spills."""
    ms = _time_ms(run, 50)
    plain_ms = _time_ms(plain, 3, warm=1)
    bms, bby = _bound(nbytes, ops)
    px = _ptxas(Path(source).stem, kernel)
    print(f"[kernels] {tag} {ms:.4f} ms (plain {plain_ms:.3f} ms), needs {nbytes} "
          f"bytes, {ops} operations -> bound {bms:.4f} ms ({bby}), {ms / bms:.1f}x the "
          f"bound; {px['regs']} registers, {px['stack']} bytes stack frame, "
          f"{px['spill_st']} / {px['spill_ld']} bytes spill stores / loads ({GPU})")
    if spill_free and px["stack"] + px["spill_st"] + px["spill_ld"]:
        raise AssertionError(f"{tag} spills to local memory: {px}")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=None)


def _print_work(route, w):
    print(f"[kernels] {route} work at the start pose: forward {w['fwd'][0]} lane-pixel "
          f"pairs in the lanes' band-dilated bboxes (whole-tile rule {w['fwd'][3]}) over "
          f"{w['fwd'][1]} live slots in {w['fwd'][2]} chunks; {w['tiles']} visited tiles; "
          f"heaviest tile {w['heavy'][0]} lanes reaching it, {w['heavy'][1]} pairs"
          + "".join(f"; backward {k} {v[0]} live pairs (whole-tile rule {v[3]}) over {v[1]} "
                    f"live slots in {v[2]} chunks"
                    for k, v in w.items() if k not in ("fwd", "tiles", "heavy")))


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
    _check_repeat("K2f", lambda: _fwd_out(prc.loss_fwd_compact_cuda(*fargs)))
    acck = got[1]
    gb = torch.full((B,), 1.0 / B, device=cam.device)
    bargs = (cam, st.rec, st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref, acck, gb, meta)
    b_err = _check_dcam("K2b", prc.loss_bwd_compact_cuda(*bargs).sum(1),
                        prc.loss_bwd_compact_plain(*bargs).sum(1))
    _check_repeat("K2b", lambda: prc.loss_bwd_compact_cuda(*bargs).sum(1))
    print(f"[kernels] start-pose loads: max tile count {int(st.counts.max())} "
          f"(cap {cfg.capacity}), max ncu {int(st.ncu.max())} (budget {cfg.compact_chunks})")

    # The boundary-prefix backward map (bwd_chunks > 0): K3 on the card finds
    # the tiles that can hold a band pixel, K2b runs on their chunks only.
    rb = copy.copy(renderer)
    rb.tile = cfg._replace(bwd_chunks=cfg.compact_chunks)
    bst = rb.bin_state(se3.exp(d0), lp, K)
    if bool(bst.overflow):
        raise AssertionError("boundary-prefix map overflow at the start pose")
    mb = (cam, bst.rec, bst.bwd_nlive, bst.bwd_ctmap, bst.bwd_cpos, ref, acck, gb, meta)
    pb = prc.loss_bwd_compact_cuda(*mb).sum(1)
    _check_dcam("K2b on the boundary-prefix map", pb, prc.loss_bwd_compact_plain(*mb).sum(1))
    pfull = prc.loss_bwd_compact_cuda(*bargs).sum(1)
    torch.cuda.synchronize()
    gap = (pb - pfull).abs().max().item() / pfull.abs().max().item()
    print(f"[kernels] boundary-prefix map: {int((bst.bwd_nlive > 0).sum())} backward chunks "
          f"against the forward's {int(st.ncu.sum())}; K2b's dcam on it vs on the full map "
          f"{gap:.3e} of max|dcam| (tol 1e-3: the skipped chunks hold no band pixel; "
          "summation order)")
    if not gap <= 1e-3:
        raise AssertionError("K2b on the boundary-prefix map disagrees with the full map")

    T, P, nc = ref.shape[1], TH * TW, st.nlive.shape[1]
    frames = [(prc._chunks_of(st.rec[b]), st.ctmap[b].long(), st.nlive[b].long())
              for b in range(B)]
    _check_lane_order("K2f", acck, _lane_order_acc(cam, frames, meta, T))
    gp = loss_cotangent(acck.reshape(B, T, P), ref.reshape(B, T, P), gb[:, None, None],
                        torch.arange(T, device=cam.device), meta)
    w = _needed_work(cam, frames, {"K2b": gp}, meta)
    _print_work("compact", w)
    maps = B * (nc * 8 + 4 + 64)  # nlive and ctmap (or cpos), ncu (or gb), cam
    src = "easyhec_torch/ops/csrc/pose_raster_compact.cu"
    return [
        # records of the live slots run and ref of visited tiles in; acc and loss out
        _row("loss_fwd_compact", "K2f", src, "easyhec_tpu/ops/pose_raster_compact.py:66",
             f_err, lambda: prc.loss_fwd_compact_cuda(*fargs),
             lambda: prc.loss_fwd_compact_plain(*fargs),
             w["fwd"][1] * SLOT_BYTES + w["tiles"] * P * 4 + B * T * (P + 1) * 4 + maps,
             _ops(w["fwd"], OPS_FWD_PAIR, OPS_FWD_LANE), "loss_fwd_compact_kernel",
             spill_free=True),
        # records of the live slots and acc + ref of visited tiles in; parts out
        _row("loss_bwd_compact", "K2b", src, "easyhec_tpu/ops/pose_raster_compact.py:105",
             b_err, lambda: prc.loss_bwd_compact_cuda(*bargs),
             lambda: prc.loss_bwd_compact_plain(*bargs),
             w["K2b"][1] * SLOT_BYTES + w["tiles"] * 2 * P * 4 + maps + B * nc * (4 + 48),
             _ops(w["K2b"], OPS_BWD_PAIR, OPS_BWD_LANE), "loss_bwd_compact_kernel",
             spill_free=True),
    ]


def check_tile_acc(tag, cam, st, th, tw):
    """compact_tile_acc (K3: the compact forward kernel with a zero
    reference, which renders the target masks) against the plain forward
    on the compact bin state st of th x tw tiles."""
    import torch

    from easyhec_torch.ops import pose_raster_compact as prc

    T, n_tx = st.counts.shape[1], -(-W // tw)
    acc_k = prc.compact_tile_acc(cam, st.rec, st.nlive, st.ctmap, st.ncu, T, th, tw,
                                 n_tx, H, W)
    zeros = torch.zeros_like(acc_k)
    meta = prc.Meta(th, tw, n_tx, H, W)
    _, acc_p = prc.loss_fwd_compact_plain(cam, st.rec, st.nlive, st.ctmap, st.ncu,
                                          zeros, meta)
    err = (acc_k.clamp(max=2) - acc_p.clamp(max=2)).abs().max().item()
    print(f"[kernels] {tag} compact_tile_acc (K2f, zero reference): min(acc,2) max abs "
          f"err {err:.3e} (tol 1e-3, as for K2f)")
    if not err <= 1e-3:
        raise AssertionError(f"{tag} compact_tile_acc disagrees with the plain forward")


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
    _check_repeat("K1f", lambda: _fwd_out(pr.loss_fwd_cuda(*fargs)))
    frames = _dense_frames(rec, counts)
    _check_lane_order("K1f", got[1], _lane_order_acc(cam, frames, meta, T))
    acck = got[1]
    gb = torch.full((B,), 1.0 / B, device=cam.device)
    bargs = (cam, rec, counts, ref, acck, gb, meta)
    k1b_err = _check_dcam("K1b", pr.loss_bwd_cuda(*bargs).sum(1),
                          pr.loss_bwd_plain(*bargs).sum(1))
    _check_repeat("K1b", lambda: pr.loss_bwd_cuda(*bargs).sum(1))

    # K4f: the clipped image (tolerance of min(acc, 2)).
    sargs = (cam, rec, counts, meta)
    sk, acc_s = pr.sil_fwd_cuda(*sargs)
    spl, _ = pr.sil_fwd_plain(*sargs)
    torch.cuda.synchronize()
    k4f_err = (sk - spl).abs().max().item()
    print(f"[kernels] K4f image: max abs err {k4f_err:.3e} (tol 1e-3, as min(acc,2))")
    if not k4f_err <= 1e-3:
        raise AssertionError("K4f disagrees with its plain version")
    _check_repeat("K4f", lambda: _fwd_out(pr.sil_fwd_cuda(*sargs)))
    if not torch.equal(acc_s.clamp(max=2), acck.clamp(max=2)):
        raise AssertionError("K4f's min(acc, 2) is not K1f's")

    # K4b: the cotangent of mean Σ(sil − target)², through the wrapper and
    # through autograd on RobotRenderer.silhouette (same bin state).
    g_img = 2.0 * (_untile(sk, H, W, cfg) - target) / B
    g_t = tile_image(g_img, TH, TW).contiguous()
    gargs = (cam, rec, counts, acc_s, g_t, meta)
    qpl = pr.sil_bwd_plain(*gargs).sum(1)
    k4b_err = _check_dcam("K4b", pr.sil_bwd_cuda(*gargs).sum(1), qpl)
    _check_repeat("K4b", lambda: pr.sil_bwd_cuda(*gargs).sum(1))
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
    w = _needed_work(cam, frames, gps, meta)
    _print_work("dense", w)
    img = B * T * P * 4
    small = B * T * 4 + B * 64  # counts, cam
    fwd_bytes = w["fwd"][1] * SLOT_BYTES + small + 2 * img  # + (K1f) ref in, or image out
    fwd_ops = _ops(w["fwd"], OPS_FWD_PAIR, OPS_FWD_LANE)

    def bwd_bytes(k):  # records of the live slots, acc + ref (or g) of visited tiles; parts out
        return w[k][1] * SLOT_BYTES + w["tiles"] * 2 * P * 4 + small + B * T * 48

    src = "easyhec_torch/ops/csrc/pose_raster.cu"
    at = "easyhec_tpu/ops/pose_raster.py:"
    return [
        _row("loss_fwd", "K1f", src, at + "648", k1f_err, lambda: pr.loss_fwd_cuda(*fargs),
             lambda: pr.loss_fwd_plain(*fargs), fwd_bytes + B * T * 4, fwd_ops,
             "pose_fwd_kernelILb1E", spill_free=True),
        _row("loss_bwd", "K1b", src, at + "681", k1b_err, lambda: pr.loss_bwd_cuda(*bargs),
             lambda: pr.loss_bwd_plain(*bargs), bwd_bytes("K1b") + B * 4,
             _ops(w["K1b"], OPS_BWD_PAIR, OPS_BWD_LANE), "pose_bwd_kernelILb1E",
             spill_free=True),
        _row("sil_fwd", "K4f", src, at + "167", k4f_err, lambda: pr.sil_fwd_cuda(*sargs),
             lambda: pr.sil_fwd_plain(*sargs), fwd_bytes, fwd_ops, "pose_fwd_kernelILb0E",
             spill_free=True),
        _row("sil_bwd", "K4b", src, at + "490", k4b_err, lambda: pr.sil_bwd_cuda(*gargs),
             lambda: pr.sil_bwd_plain(*gargs), bwd_bytes("K4b"),
             _ops(w["K4b"], OPS_BWD_PAIR, OPS_BWD_LANE), "pose_bwd_kernelILb0E",
             spill_free=True),
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
    lane-pixel pair counts when its slot is live and the pixel centre lies
    in its bbox dilated by the soft band 0.5/sharpness (and, for the
    backward, the pixel's cotangent is live); forward chunks that the
    saturation early-out skips are not counted; the backward visits only
    the live cotangent pixels of its tile (gp [B, T, P] = g·1{acc <= 1}).
    Returns {"fwd": [pairs, chunks, whole-tile pairs, live slots], "bwd":
    [pairs, chunks, whole-tile pairs, live slots], "bwd_tiles": tiles with a
    live pixel, "written": the slots below their tile's count, which the
    counted K5b writes}; the whole-tile pairs count every pixel (every live
    pixel) of the tile for each live slot whose band-dilated bbox reaches
    the tile."""
    import torch

    from easyhec_torch.ops.pose_raster import band_mask, pix_grids
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
    lox, loy, hix, hiy = (blk[:, f] for f in (9, 10, 11, 12))
    ok = (live & (hix + reach > 0) & (lox - reach < meta.tw)
          & (hiy + reach > 0) & (loy - reach < meta.th))
    nok, nlv = ok.sum(-1), live.sum(-1)
    px, py = pix_grids(meta.th, meta.tw, dev)
    live_g = gp.reshape(B * T, P) != 0
    live_px = live_g.sum(-1)[tile]
    pairs = torch.zeros((2, tile.numel()), dtype=torch.long, device=dev)
    deltas = []
    for a, b in _blocks(tile.numel(), P):
        deltas.append(_chunk_coverage(blk[a:b], rem[a:b], px, py, meta.sharpness)[0].sum(1))
        s = {"valid": live[a:b], "bbox": tuple(x[a:b] for x in (lox, loy, hix, hiy))}
        inb = band_mask(s, px, py, meta.sharpness)  # [n, C, P]
        pairs[0, a:b] = inb.sum(dim=(-2, -1))
        pairs[1, a:b] = (inb & live_g[tile[a:b]][:, None, :]).sum(dim=(-2, -1))
    delta = torch.cat(deltas)
    n = tile.numel()
    ar = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = tile[1:] != tile[:-1]
    start = torch.cummax(torch.where(first, ar, 0), 0)[0]
    cs = torch.cumsum(delta, dim=0)
    base = torch.where((start > 0)[:, None], cs[(start - 1).clamp(min=0)], 0.0)
    run = ~((cs - delta - base).amin(dim=-1) >= 2.0)
    use = live_px > 0
    return {"fwd": [int((pairs[0] * run).sum()), int(run.sum()), int((nok * P * run).sum()),
                    int((nlv * run).sum())],
            "bwd": [int((pairs[1] * use).sum()), int(use.sum()),
                    int((nok * live_px * use).sum()), int((nlv * use).sum())],
            "bwd_tiles": int(live_g.any(-1).sum()),
            "written": int(counts.long().clamp(0, cap).sum())}


def _print_k5_work(what, w):
    print(f"[kernels] {what}: forward {w['fwd'][0]} lane-pixel pairs in the lanes' "
          f"band-dilated bboxes (whole-tile rule {w['fwd'][2]}) over {w['fwd'][3]} live "
          f"slots in {w['fwd'][1]} chunks; backward {w['bwd'][0]} live pairs (whole-tile rule "
          f"{w['bwd'][2]}) over {w['bwd'][3]} live slots in {w['bwd'][1]} chunks in "
          f"{w['bwd_tiles']} tiles; the counted K5b writes {w['written']} slots")


def _k5_slot_order_acc(rec, counts, meta):
    """The plain K5 coverage summed slot after slot, in slot order per tile
    (the order of K5f's sums), each pair through tile_raster's
    _chunk_coverage: [B, T, th, tw]."""
    import torch

    from easyhec_torch.ops.pose_raster import pix_grids
    from easyhec_torch.ops.tile_raster import CHUNK, TRI_RECORD, _blocks, _chunk_coverage, \
        _used_chunks

    B, T, _, cap = rec.shape
    P = meta.th * meta.tw
    px, py = pix_grids(meta.th, meta.tw, rec.device)
    flat = rec.reshape(B * T, TRI_RECORD, cap // CHUNK, CHUNK)
    tile, j, rem = _used_chunks(counts.reshape(-1), cap)
    acc = torch.zeros((B * T, P), dtype=torch.float32, device=rec.device)
    for jj in range(int(j.max()) + 1 if j.numel() else 0):  # a tile's chunks in order
        sel = (j == jj).nonzero()[:, 0]
        for a, b in _blocks(sel.numel(), P):
            ids = sel[a:b]
            rows = tile[ids]
            cov = _chunk_coverage(flat[rows, :, jj], rem[ids], px, py, meta.sharpness)[0]
            for lane in range(CHUNK):
                acc[rows] = acc[rows] + cov[:, lane]
    return acc.reshape(B, T, meta.th, meta.tw)


def _check_k5(tag, rec, st, meta, n_tx, cap, g_t, ref_acc=None):
    """K5f, the dense K5b and the counted K5b against their plain versions
    on the records rec of bin state st (bins' cap `cap`) with the image
    cotangent g_t, each run twice and held bit for bit (K5f at min(acc, 2),
    the counted K5b through the gather at q). ref_acc: the plain slot-order
    sum, compared bit for bit with min(acc, 2). Returns (acc, errors of K5f,
    dense K5b and counted K5b's dfields)."""
    import torch

    from easyhec_torch.ops import tile_raster as tr
    from easyhec_torch.render.binning import _gather_at_q

    counts = st.counts
    ok_, acck = tr.tile_fwd_cuda(rec, counts, meta)
    op_, accp = tr.tile_fwd_plain(rec, counts, meta)
    torch.cuda.synchronize()
    img_err = (ok_ - op_).abs().max().item()
    acc_err = (acck.clamp(max=2) - accp.clamp(max=2)).abs().max().item()
    print(f"[kernels] {tag} K5f image: max abs err {img_err:.3e}; min(acc,2) max abs err "
          f"{acc_err:.3e} (tol 1e-3 each, as K1f/K2f: summation order over slots)")
    if not (img_err <= 1e-3 and acc_err <= 1e-3):
        raise AssertionError(f"{tag} K5f disagrees with its plain version")
    _check_repeat(f"{tag} K5f", lambda: _fwd_out(tr.tile_fwd_cuda(rec, counts, meta)))
    if ref_acc is not None:
        _check_lane_order(f"{tag} K5f", acck, ref_acc)

    bargs = (rec, counts, acck, g_t, meta)
    dk, dp = tr.tile_bwd_cuda(*bargs), tr.tile_bwd_plain(*bargs)
    torch.cuda.synchronize()
    scale = dp.abs().max().item()
    d_err = (dk - dp).abs().max().item()
    print(f"[kernels] {tag} dense K5b dtri: max abs err {d_err:.3e}, max|dtri| {scale:.3e} "
          "(tol 1e-3*max|dtri|). Reason: summation order over pixels")
    if not (scale > 0 and d_err <= 1e-3 * scale):
        raise AssertionError(f"{tag} dense K5b disagrees with its plain version")
    _check_repeat(f"{tag} dense K5b", lambda: tr.tile_bwd_cuda(*bargs))

    cargs = bargs + (n_tx, cap)
    fk = _gather_at_q(tr.tile_bwd_counted_cuda(*cargs), st.q)
    fp = _gather_at_q(tr.tile_bwd_counted_plain(*cargs), st.q)
    torch.cuda.synchronize()
    fscale = fp.abs().max().item()
    f_err = (fk - fp).abs().max().item()
    print(f"[kernels] {tag} counted K5b dfields (through the gather at q): max abs err "
          f"{f_err:.3e}, max|dfields| {fscale:.3e} (tol 1e-3*max|dfields|). Reason: summation "
          "order over pixels")
    if not (fscale > 0 and f_err <= 1e-3 * fscale and torch.isfinite(fk).all()):
        raise AssertionError(f"{tag} counted K5b disagrees with its plain version")
    _check_repeat(f"{tag} counted K5b",
                  lambda: _gather_at_q(tr.tile_bwd_counted_cuda(*cargs), st.q))
    return acck, max(img_err, acc_err), d_err, f_err


def _k5_rows(tag, rec, st, meta, n_tx, cap, g_t, acck, errs, replaces=""):
    """Time and bound K5f, the dense K5b and the counted K5b (_row) on the
    inputs _check_k5 held; -> their rows."""
    from easyhec_torch.ops import tile_raster as tr

    counts = st.counts
    B, T = counts.shape
    P = meta.th * meta.tw
    gp = (g_t * (acck <= 1.0).float()).reshape(B, T, P)
    w = _k5_work(rec, counts, gp, meta)
    _print_k5_work(f"{tag} work", w)
    img = B * T * P * 4
    bargs = (rec, counts, acck, g_t, meta)
    live_in = w["bwd"][3] * K5_SLOT_BYTES + w["bwd_tiles"] * 2 * P * 4 + B * T * 4
    src = "easyhec_torch/ops/csrc/tile_raster.cu"
    return [
        # records of the live slots run and counts in; clip(acc) and acc out
        _row("tile_fwd", f"{tag} K5f", src, replaces and replaces + "95", errs[0],
             lambda: tr.tile_fwd_cuda(rec, counts, meta),
             lambda: tr.tile_fwd_plain(rec, counts, meta),
             w["fwd"][3] * K5_SLOT_BYTES + B * T * 4 + 2 * img, w["fwd"][0] * OPS_FWD_PAIR,
             "tile_fwd_kernel", spill_free=True),
        # records of the live slots, acc and g of the live tiles in; all of dtri out
        _row("tile_bwd", f"{tag} dense K5b", src, replaces and replaces + "121", errs[1],
             lambda: tr.tile_bwd_cuda(*bargs), lambda: tr.tile_bwd_plain(*bargs),
             live_in + rec.numel() * 4, w["bwd"][0] * OPS_BWD_PAIR, "8DenseOut",
             spill_free=True),
        # the same in; 13 floats per slot below its count out
        _row("tile_bwd_counted", f"{tag} counted K5b", src, replaces and replaces + "121",
             errs[2], lambda: tr.tile_bwd_counted_cuda(*bargs, n_tx, cap),
             lambda: tr.tile_bwd_counted_plain(*bargs, n_tx, cap),
             live_in + w["written"] * K5_SLOT_BYTES, w["bwd"][0] * OPS_BWD_PAIR,
             "10CountedOut", spill_free=True),
    ]


def unfused_kernel_phase(r, lp, K, xi, target):
    """K5f and K5b (dense and counted) against their plain versions at the
    full shapes of the unfused route, on the records at the start pose;
    min(acc, 2) against the plain slot-order sum; dTc through autograd on
    RobotRenderer.silhouette (the counted route) against the plain K5b's
    dtri chained through the same record pack. Returns the rows."""
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
    rec = tr.pad_cap(rec).contiguous()
    counts = st.counts
    T = counts.shape[1]
    print(f"[unfused] start-pose loads: max tile count {int(counts.max())} (cap "
          f"{cfg.capacity}), {int((counts > 0).sum())} of {B * T} tiles visited; records "
          f"{rec.numel() * 4} bytes")
    meta = tr.TileMeta(TH, TW, 1.0)
    n_tx = -(-W // TW)
    sil, _ = tr.tile_fwd_plain(rec, counts, meta)
    g_img = 2.0 * (_untile(sil, H, W, cfg) - target) / B  # d mean Σ(sil − target)²
    g_t = tile_image(g_img, TH, TW).contiguous()
    acck, *errs = _check_k5("unfused", rec, st, meta, n_tx, cfg.capacity, g_t,
                            _k5_slot_order_acc(rec, counts, meta))

    dp = tr.tile_bwd_plain(rec, counts, acck, g_t, meta)
    Tk = Tc.clone().requires_grad_()
    n0 = (tr.tile_bwd_counted_cuda.launches, tr.tile_bwd_cuda.launches)
    (gk,) = torch.autograd.grad(r.silhouette(Tk, lp, K, bin_state=st), Tk, g_img)
    Tp = Tc.clone().requires_grad_()
    (gp_,) = torch.autograd.grad(_k5_records(r, lp, K, Tp, st)[0], Tp,
                                 dp[..., :cfg.capacity])
    torch.cuda.synchronize()
    if (tr.tile_bwd_counted_cuda.launches, tr.tile_bwd_cuda.launches) != (n0[0] + 1, n0[1]):
        raise AssertionError("autograd through RobotRenderer.silhouette did not launch the "
                             "counted K5b alone")
    want = gp_[:3, :4]
    ag_err = (gk[:3, :4] - want).abs().max().item()
    print(f"[kernels] dTc through autograd on RobotRenderer.silhouette (counted K5b) vs the "
          f"plain K5b's dtri through the same record pack: {ag_err:.3e} of max "
          f"{want.abs().max().item():.3e} (tol 1e-3*max). Reason: summation order")
    if not ag_err <= 1e-3 * want.abs().max().item():
        raise AssertionError("the counted K5b through autograd disagrees with its plain version")
    return _k5_rows("unfused", rec, st, meta, n_tx, cfg.capacity, g_t, acck, errs,
                    "easyhec_tpu/ops/tile_raster.py:")


def large_tile_phase():
    """K1, K2 (K3 too) and K4 on 32×128 tiles (4096 pixels: the forwards in
    16 regions of 8x32 pixels per tile, the backwards over one live list of
    up to 4096 pixels) at the bench scene, against their plain versions,
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
          f"{pr.n_sub(pr.Meta(th, tw, 1, H, W))} 8x32 pixel regions in the forwards); "
          "start-pose max load "
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
    _check_repeat("K1f 32x128", lambda: _fwd_out(pr.loss_fwd_cuda(*fa)))
    T = counts.shape[1]
    _check_lane_order("K1f 32x128", got[1], _lane_order_acc(cam, _dense_frames(rec, counts),
                                                            meta, T))
    ba = (cam, rec, counts, ref, got[1], gb, meta)
    _check_dcam("K1b 32x128", pr.loss_bwd_cuda(*ba).sum(1), pr.loss_bwd_plain(*ba).sum(1))
    sk, acc_s = pr.sil_fwd_cuda(cam, rec, counts, meta)
    e4 = (sk - pr.sil_fwd_plain(cam, rec, counts, meta)[0]).abs().max().item()
    print(f"[kernels] K4f 32x128 image: max abs err {e4:.3e} (tol 1e-3)")
    if not e4 <= 1e-3:
        raise AssertionError("K4f on 32x128 tiles disagrees with its plain version")
    _check_repeat("K4f 32x128", lambda: _fwd_out(pr.sil_fwd_cuda(cam, rec, counts, meta)))
    g = torch.randn(sk.shape, generator=torch.Generator(device=DEVICE).manual_seed(0),
                    device=DEVICE)
    ga = (cam, rec, counts, acc_s, g, meta)
    _check_dcam("K4b 32x128", pr.sil_bwd_cuda(*ga).sum(1), pr.sil_bwd_plain(*ga).sum(1))
    ca = (cam, cst.rec, cst.nlive, cst.ctmap, cst.ncu, ref, meta)
    got = prc.loss_fwd_compact_cuda(*ca)
    _check_loss_fwd("K2f 32x128", got, prc.loss_fwd_compact_plain(*ca))
    _check_repeat("K2f 32x128", lambda: _fwd_out(prc.loss_fwd_compact_cuda(*ca)))
    cframes = [(prc._chunks_of(cst.rec[b]), cst.ctmap[b].long(), cst.nlive[b].long())
               for b in range(B)]
    _check_lane_order("K2f 32x128", got[1], _lane_order_acc(cam, cframes, meta, T))
    check_tile_acc("32x128", cam, cst, th, tw)
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


def trainer_phase(lp, K, xi, qs, target, steps, out_dir):
    """run_offline_calibration on the dense route at the bench scene, with an
    in-memory Config and CalibBatch (the GPU machine has no PyYAML or
    OpenCV, so nothing is read from disk but the URDF), writing its run
    under ``out_dir``. Returns (launches, ms/step, the Config, the batch)."""
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

    cfg.output_dir = str(out_dir)
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
    out = Path(out_dir)
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
    return launches, wall / steps * 1e3, cfg, batch


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

    kernels = {"tile_fwd": tr.tile_fwd_cuda, "tile_bwd_counted": tr.tile_bwd_counted_cuda,
               "tile_bwd": tr.tile_bwd_cuda}
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
    if launches != {"tile_fwd": 48 + 2 + 200 + 1, "tile_bwd_counted": 200, "tile_bwd": 0}:
        raise AssertionError(f"K5 launches {launches} in the global search")
    return res


def search_kernel_phase(renderer, lp, K, target, res):
    """K5f and K5b (dense and counted) at the shapes the global search
    launches them: its scoring renderer (60x80 at 1/8 resolution, 16x32
    tiles, T = 12, the renderer's cap) on frame 0, on a sweep batch (the
    first 64 candidates: 48 K5f launches per search) and on the
    refinement's batch (the sweep's top 16 candidates, before the moment
    refinement: 200 launches of K5f and of the counted K5b), against their
    plain versions, with the device time, the bound and the ratio of each
    (_k5_rows)."""
    import torch

    from easyhec_torch.models.calib import downscale_K
    from easyhec_torch.models.pose_init import _scoring_renderer
    from easyhec_torch.ops import tile_raster as tr
    from easyhec_torch.ops.pose_raster import tile_image
    from easyhec_torch.render.tiled import _untile

    ds = 8
    Hs, Ws = H // ds, W // ds
    sr = _scoring_renderer(renderer, Hs, Ws)
    cfg = sr.tile
    Ks = torch.tensor(downscale_K(K.cpu().numpy(), ds), device=DEVICE)
    mask = target[0].reshape(Hs, ds, Ws, ds).mean((1, 3))
    poses = torch.from_numpy(res.poses).to(DEVICE)
    top = torch.argsort(torch.from_numpy(-res.scores), stable=True)[:16].to(DEVICE)
    meta = tr.TileMeta(cfg.tile_h, cfg.tile_w, 1.0)
    n_tx = -(-Ws // cfg.tile_w)
    for what, Tc in (("sweep batch", poses[:64]), ("refine batch", poses[top])):
        n = Tc.shape[0]
        with torch.no_grad():
            rec, st = _k5_records(sr, lp[:1].expand((n,) + lp.shape[1:]), Ks, Tc)
        rec = tr.pad_cap(rec).contiguous()
        counts = st.counts
        Bn, T = counts.shape
        print(f"[kernels search] {what}: {Bn} frames of {Ws}x{Hs}, {T} tiles of "
              f"{cfg.tile_h}x{cfg.tile_w}, cap {cfg.capacity}, {int(counts.max())} max load, "
              f"{float((counts >= cfg.capacity).float().mean()):.4f} of tiles at cap")
        sil, _ = tr.tile_fwd_plain(rec, counts, meta)
        g_t = tile_image(2.0 * (_untile(sil, Hs, Ws, cfg) - mask), cfg.tile_h,
                         cfg.tile_w).contiguous()
        tag = f"search {what}"
        acck, *errs = _check_k5(tag, rec, st, meta, n_tx, cfg.capacity, g_t)
        _k5_rows(tag, rec, st, meta, n_tx, cfg.capacity, g_t, acck, errs)


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
    kernels = {"tile_fwd": tr.tile_fwd_cuda, "tile_bwd_counted": tr.tile_bwd_counted_cuda,
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
    if launches["tile_fwd"] != 1 + 251 or launches["tile_bwd_counted"] != 200:
        raise AssertionError(f"K5 launches {launches} in the global-search trainer run")
    if launches["loss_bwd_compact"] < steps:
        raise AssertionError(f"K2 launches {launches} for {steps} steps")
    return launches


def _all_kernels():
    """Every kernel wrapper's launch counter, by name."""
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops import tile_raster as tr

    return {"loss_fwd": pr.loss_fwd_cuda, "loss_bwd": pr.loss_bwd_cuda,
            "sil_fwd": pr.sil_fwd_cuda, "sil_bwd": pr.sil_bwd_cuda,
            "loss_fwd_compact": prc.loss_fwd_compact_cuda,
            "loss_bwd_compact": prc.loss_bwd_compact_cuda,
            "tile_fwd": tr.tile_fwd_cuda, "tile_bwd": tr.tile_bwd_cuda,
            "tile_bwd_counted": tr.tile_bwd_counted_cuda}


def _launched(kernels):
    return {k: fn.launches for k, fn in kernels.items() if fn.launches}


def schedules_phase(renderer, lp, K, xi, target, steps):
    """The compact route's calibrate under warmup_cosine with 100 warmup
    steps (make_optimizer's warmup_steps, as the JAX package has it; no
    config field sets it, so calibrate's optimizer factory is wrapped here).
    The schedule's lr at steps 0, 99, steps/2 and steps-1, on the card,
    against its closed form in Python floats."""
    import functools
    import math

    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models import calib
    from easyhec_torch.solver.optim import make_optimizer, make_schedule

    warm, max_lr = min(100, max(steps // 10, 1)), 3e-3
    kernels = _all_kernels()
    real = calib.make_optimizer
    calib.make_optimizer = functools.partial(make_optimizer, warmup_steps=warm)
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    try:
        res = calib.calibrate((xi + 0.01).cpu().numpy(), renderer, lp, K, target,
                              num_steps=steps, max_lr=max_lr, scheduler="warmup_cosine",
                              rebin_every=0, Tc_c2b_gt=se3.exp(xi).cpu().numpy())
    finally:
        calib.make_optimizer = real
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _launched(kernels)
    at = [0, warm - 1, steps // 2, steps - 1]
    lr = make_schedule("warmup_cosine", max_lr, steps, warmup_steps=warm)(
        torch.tensor(at, dtype=torch.int32, device=DEVICE)).cpu().numpy()

    def closed(s):  # linear warmup from max_lr/3, then cosine decay to 0
        if s < warm:
            return (max_lr / 3 - max_lr) * (1 - s / warm) + max_lr
        return max_lr * 0.5 * (1 + math.cos(math.pi * (s - warm) / (steps - warm)))

    want = np.array([closed(s) for s in at])
    # rel 1e-6, with a floor of one f32 ulp of max_lr: the last steps' 1 + cos
    # cancels, and f32 cos is within an ulp of the true value, not exact
    tol = 1e-6 * np.abs(want) + np.finfo(np.float32).eps * max_lr
    print(f"[schedules] compact calibrate, warmup_cosine ({warm} warmup steps): {steps} "
          f"steps in {dt:.3f} s, {dt / steps * 1e3:.3f} ms/step, {res.rebins} rebins; loss "
          f"{res.losses[0]:.3f} -> {res.losses[-1]:.3f}; launches {json.dumps(launches)}; "
          f"pose error {json.dumps(res.metrics)}")
    print(f"[schedules] lr at steps {at}: " + ", ".join(f"{a:.9e}" for a in lr)
          + "; closed form " + ", ".join(f"{b:.9e}" for b in want)
          + f"; max rel diff {(np.abs(lr - want) / want).max():.3e} (tol 1e-6, floor "
          f"{np.finfo(np.float32).eps * max_lr:.2e} absolute)")
    if not (np.abs(lr - want) <= tol).all():
        raise AssertionError("warmup_cosine lr disagrees with its closed form")
    if res.overflow or not res.losses[-1] < res.losses[0]:
        raise AssertionError("warmup_cosine calibrate: overflow or no fall in the loss")
    if launches.get("loss_fwd_compact", 0) < steps or launches.get("loss_bwd_compact") != steps:
        raise AssertionError(f"K2 launches {launches} for {steps} steps")


def option_routes_phase(renderer, lp, K, xi, frames=4, Ho=60, Wo=80, steps=20):
    """[brute] and [xla tiled]: RobotRenderer(mode="brute") and a
    use_pallas=False renderer, both on the bench's compact tile config (the
    fused gates must fall through to them) without backface culling, on
    the bench arm at Wo x Ho over the first `frames` frames. Each route's
    silhouette against K5f's (the unfused route at a capacity that drops
    no triangle here), its pose gradient against the compact route's, and
    `steps` calibrate steps; no kernel may launch on either route."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate, mask_loss, tile_masks
    from easyhec_torch.render import RobotRenderer

    f = F_PX * Wo / 640.0
    Ko = torch.tensor([[f, 0, Wo / 2], [0, f, Ho / 2], [0, 0, 1]], device=DEVICE)
    lpo, T0 = lp[:frames], se3.exp(xi)
    d0 = (xi + 0.01).detach()
    base = renderer.tile._replace(cull_backfaces=False)
    probe = RobotRenderer(renderer.meshes, Ho, Wo, device=DEVICE, tile=base._replace(
        fused=False, compact_chunks=0, capacity=renderer.n_faces))
    loads = max(int(probe.bin_state(T, lpo, Ko).counts.max()) for T in (T0, se3.exp(d0)))
    cap = -(-loads * 5 // 4 // 128) * 128
    n_tiles = -(-Ho // base.tile_h) * -(-Wo // base.tile_w)
    tile = base._replace(capacity=cap, compact_chunks=n_tiles * cap // 128)
    k5 = RobotRenderer(renderer.meshes, Ho, Wo, device=DEVICE,
                       tile=tile._replace(fused=False, compact_chunks=0))
    compact = RobotRenderer(renderer.meshes, Ho, Wo, device=DEVICE, tile=tile)
    with torch.no_grad():
        target = (k5.silhouette(T0, lpo, Ko) > 0.5).float()
        sil_k5 = k5.silhouette(se3.exp(d0), lpo, Ko)
    print(f"[brute] bench arm at {Wo}x{Ho}, {frames} frames: max tile load {loads}, so "
          f"capacity {cap} for the kernel routes (no overflow); target "
          f"{float(target.mean()):.4f} of pixels set")

    def grad(r, **kw):
        d = d0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(mask_loss(d, r, lpo, Ko, target, **kw), d)
        return g

    kernels = _all_kernels()
    _reset(kernels)
    st = compact.bin_state(se3.exp(d0), lpo, Ko)
    g_c = grad(compact, bin_state=st, ref_tiles=tile_masks(target, compact))
    if not _launched(kernels):
        raise AssertionError("the compact route launched no kernel")
    for label, r in (("brute", RobotRenderer(renderer.meshes, Ho, Wo, tile=tile, mode="brute",
                                             device=DEVICE)),
                     ("xla tiled 80x60", RobotRenderer(renderer.meshes, Ho, Wo, device=DEVICE,
                                                       tile=tile._replace(use_pallas=False)))):
        torch.cuda.synchronize()
        _reset(kernels)
        with torch.no_grad():
            diff = float((r.silhouette(se3.exp(d0), lpo, Ko) - sil_k5).abs().max())
        g = grad(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = calibrate(d0.cpu().numpy(), r, lpo, Ko, target, num_steps=steps, rebin_every=0,
                        Tc_c2b_gt=T0.cpu().numpy())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gap = float((g - g_c).abs().max() / g_c.abs().max())
        print(f"[{label}] silhouette at the start pose vs K5f: max abs diff {diff:.3e}; "
              f"d(loss)/d(dof) vs the compact route's (K2b, band-only backward): max diff "
              f"{gap:.3e} of max|g|; calibrate {steps} steps: {dt / steps * 1e3:.3f} ms/step, "
              f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}, {res.rebins} rebins; kernel "
              f"launches {json.dumps(_launched(kernels))}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if _launched(kernels):
            raise AssertionError(f"a kernel launched on the {label} route")
        if not (diff <= 1e-4 and np.isfinite(res.losses).all()
                and res.losses[-1] < res.losses[0] and torch.isfinite(g).all()):
            raise AssertionError(f"the {label} route disagrees with K5f or did not descend")


def xla_tiled_phase(renderer, lp, K, xi, target, steps=2):
    """[xla tiled] at the bench scene: the bench tile config with
    use_pallas=False, so the fused gates fall through to the plain-tensor
    route (top-k bins, 128-record chunks). That route takes the AoS
    triangles, which skip backface culling (as in the JAX package), so its
    loads are those of the unculled mesh: the bench's cap 1664 is checked
    for overflow on it, and the measured run takes the unculled peak tile
    load plus a quarter, in 128-record steps. Its silhouette at the start
    pose against K5f's and its pose gradient against the counted K5b's, on
    the unfused route at the same capacity without culling, then `steps`
    calibrate steps; no kernel may launch on the plain route.

    The two silhouettes sum the same nonnegative f32 coverages in another
    order (K5f in slot order, the plain route in top-k order by 128-record
    chunks) until the sum passes 1, so a pixel of a tile holding n of them
    may differ by up to 2·(n - 1)·2^-24: the tolerance is that bound at the
    capacity."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate, mask_loss
    from easyhec_torch.render import RobotRenderer
    from easyhec_torch.render.tiled import silhouette_tiled

    d0, T0 = (xi + 0.01).detach(), se3.exp(xi)
    base = renderer.tile._replace(cull_backfaces=False, use_pallas=False)
    kernels = _all_kernels()
    _reset(kernels)
    bench = RobotRenderer(renderer.meshes, H, W, device=DEVICE,
                          tile=renderer.tile._replace(use_pallas=False))
    with torch.no_grad():
        tris = bench._triangles(bench.camera_link_poses(se3.exp(d0), lp), K)
        _, ov_bench = silhouette_tiled(tris, H, W, bench.tile, return_overflow=True)
    probe = RobotRenderer(renderer.meshes, H, W, device=DEVICE, tile=base._replace(
        use_pallas=True, fused=False, compact_chunks=0, capacity=renderer.n_faces))
    loads = max(int(probe.bin_state(T, lp, K).counts.max()) for T in (T0, se3.exp(d0)))
    del probe
    cap = -(-loads * 5 // 4 // 128) * 128
    k5 = RobotRenderer(renderer.meshes, H, W, device=DEVICE, tile=base._replace(
        use_pallas=True, fused=False, compact_chunks=0, capacity=cap))
    plain = RobotRenderer(renderer.meshes, H, W, device=DEVICE,
                          tile=base._replace(capacity=cap))

    def grad(r):
        d = d0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(mask_loss(d, r, lp, K, target), d)
        return g

    with torch.no_grad():
        sil_k5 = k5.silhouette(se3.exp(d0), lp, K)
    g_k5 = grad(k5)
    if not _launched(kernels).get("tile_bwd_counted"):
        raise AssertionError("the unfused route launched no counted K5b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    with torch.no_grad():
        diff = float((plain.silhouette(se3.exp(d0), lp, K) - sil_k5).abs().max())
    g = grad(plain)
    gap = float((g - g_k5).abs().max() / g_k5.abs().max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = calibrate(d0.cpu().numpy(), plain, lp, K, target, num_steps=steps, max_lr=3e-3,
                    rebin_every=0, Tc_c2b_gt=T0.cpu().numpy())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[xla tiled] bench scene, {B} frames of {W}x{H}, use_pallas=False: the bench "
          f"config's cap {renderer.tile.capacity} overflows on this route: {bool(ov_bench)} "
          f"(no backface culling on the AoS triangles, as in the JAX package); unculled "
          f"peak tile load {loads}, so capacity {cap}")
    print(f"[xla tiled] silhouette at the start pose vs K5f (unfused route, cap {cap}, no "
          f"culling): max abs diff {diff:.3e} (tol 2(cap-1)2^-24 = "
          f"{2 * (cap - 1) * 2.0**-24:.3e}); d(loss)/d(dof) vs the counted K5b's: max diff "
          f"{gap:.3e} of max|g|; calibrate {steps} steps: {dt:.3f} s, "
          f"{dt / steps * 1e3:.3f} ms/step, loss {res.losses[0]:.3f} -> "
          f"{res.losses[-1]:.3f}, overflow {bool(res.overflow)}; kernel launches "
          f"{json.dumps(_launched(kernels))}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {GPU}")
    if _launched(kernels):
        raise AssertionError("a kernel launched on the use_pallas=False route")
    if not (diff <= 2 * (cap - 1) * 2.0**-24 and gap <= 1e-3 and not res.overflow
            and np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]):
        raise AssertionError("the use_pallas=False route at the bench scene disagrees with "
                             "K5, overflowed or did not descend")


def ring_phase(renderer, K, views=8):
    """generate_pose_dataset (simulate --ring) at the bench scene's width:
    the zero qpos from `views` cameras on the default ring, rendered in one
    RobotRenderer.silhouette call (K4f on the compact route's dense state)."""
    import numpy as np
    import torch

    from easyhec_torch.data.synthetic import generate_pose_dataset
    from easyhec_torch.robot import build_chain, parse_urdf

    chain = build_chain(parse_urdf(ROOT / "assets" / "mini_arm.urdf"))
    kernels = _all_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        _reset(kernels)
        t0 = time.perf_counter()
        out = generate_pose_dataset(tmp, chain, renderer, ["base", "upper", "fore"],
                                    K.cpu().numpy(), n_views=views)
        dt = time.perf_counter() - t0
        n_files = sum(1 for p in Path(tmp).rglob("*") if p.is_file())
    launches = _launched(kernels)
    area = (out["masks"] > 0.5).mean(axis=(1, 2))
    print(f"[ring] generate_pose_dataset, {views} views of {W}x{H}: {dt:.3f} s, {n_files} "
          f"files, launches {json.dumps(launches)}; mask area per view "
          + np.array2string(area, precision=4) + f"; diameter {out['diameter']:.4f} m")
    if not (area > 0).all() or launches != {"sil_fwd": 1}:
        raise AssertionError("an empty ring view, or not one K4f launch for the ring")


def validate_phase(cfg, batch):
    """The validate tool on the trainer phase's checkpoint (its dense route:
    one K4f launch in render_outputs)."""
    import torch

    from easyhec_torch.cli.validate import validate

    kernels = _all_kernels()
    out = Path(cfg.output_dir) / "validate"
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    report = validate(cfg, batch=batch, out=out, device=DEVICE)
    dt = time.perf_counter() - t0
    launches = _launched(kernels)
    n_overlay = len(list(out.glob("overlay_[0-9]*.png")))
    print(f"[validate] {Path(report['checkpoint']).name}: {dt:.3f} s, mean IoU "
          f"{report['mean_iou']:.4f}, {n_overlay} overlays, launches {json.dumps(launches)}")
    if launches.get("sil_fwd") != 1 or n_overlay != batch.n_frames or not report["mean_iou"] > 0.9:
        raise AssertionError("validate: no K4f launch, missing overlays or a low IoU")


def tune_init_phase(cfg, batch, xi):
    """The tune_init tool's global search at its defaults on frame 0 of the
    trainer phase's batch (K5f and the counted K5b in the search; one K4f
    for the overlay on the dense route)."""
    import numpy as np
    import torch

    from easyhec_torch.cli.tune_init import tune_init
    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import pose_metrics

    kernels = _all_kernels()
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    T, info = tune_init(cfg, batch=batch, frame=0, global_search=True,
                        out=Path(cfg.output_dir) / "tune_init", device=DEVICE)
    dt = time.perf_counter() - t0
    launches = _launched(kernels)
    err = pose_metrics(se3.log(torch.from_numpy(np.asarray(T, np.float32))).numpy(),
                       se3.exp(xi).cpu().numpy())
    print(f"[tune_init] global search on frame 0: {dt:.3f} s, {json.dumps(info)}, launches "
          f"{json.dumps(launches)}; pose error {json.dumps(err)}")
    if not np.isfinite(T).all() or launches != {"tile_fwd": 251, "tile_bwd_counted": 200,
                                                "sil_fwd": 1}:
        raise AssertionError(f"tune_init: non-finite pose or launches {launches}")


def pnp_phase(renderer, lp, K, xi, n_pts=2000, n_iters=256):
    """ransac_pnp on `n_pts` mesh vertices (the arm posed at every frame's
    qpos, pooled in the base frame: one frame's thin arm leaves the 6-point
    DLT ill-conditioned) projected at the GT pose, with 0.5 px of noise and
    30 % uniform outliers: the pose error, and the card against the CPU on
    the same samples. The DLT is unnormalized, as the JAX package's: at
    this noise its pose is good to centimetres (5.65 cm, 2.2 deg on the
    CPU), not millimetres, so the pose error is printed, not held."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import pose_metrics
    from easyhec_torch.models.pose_init import ransac_pnp
    from easyhec_torch.render.projection import transform_verts

    rng = np.random.default_rng(7)
    verts = transform_verts(renderer.vertices, renderer.vert_link_id, lp).reshape(-1, 3)
    verts = verts.cpu().numpy()
    n_pts = min(n_pts, len(verts))
    X = verts[rng.choice(len(verts), n_pts, replace=False)]
    gt, Kn = se3.exp(xi).cpu().numpy(), K.cpu().numpy()
    pc = X @ gt[:3, :3].T + gt[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * np.diag(Kn)[:2] + Kn[:2, 2] + rng.normal(0, 0.5, (n_pts, 2))
    out = rng.random(n_pts) < 0.3
    uv[out] = rng.uniform([0, 0], [W, H], (int(out.sum()), 2))
    secs = []
    for _ in range(2):  # the first call pays the solver libraries' start-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Tc, inl_c = ransac_pnp(X, uv, Kn, n_iters=n_iters, device=DEVICE)
        secs.append(time.perf_counter() - t0)
    Tp, inl_p = ransac_pnp(X, uv, Kn, n_iters=n_iters, device="cpu")
    err = pose_metrics(se3.log(torch.from_numpy(Tc)).numpy(), gt)
    diff = float(np.abs(Tc - Tp).max())
    print(f"[pnp] ransac_pnp, {n_iters} hypotheses on {n_pts} points ({int(out.sum())} "
          f"outliers): {secs[1]:.4f} s on the card ({secs[0]:.3f} s the first call), "
          f"{int(inl_c.sum())} inliers ({int((inl_c & out).sum())} "
          f"of them outliers); pose error {json.dumps(err)}; card vs cpu: R, t max abs diff "
          f"{diff:.3e} (tol 1e-4), inlier masks differ at {int((inl_c != inl_p).sum())} points")
    if not (diff <= 1e-4 and inl_c.sum() >= 100 and (inl_c & out).sum() <= 0.01 * inl_c.sum()):
        raise AssertionError("ransac_pnp: card and cpu disagree, or its inliers are outliers")


SEG_H, SEG_W, SEG_STEPS, SEG_CAMS, SEG_FRAMES = 720, 1280, 600, 6, 8
# Card vs CPU logits of the trained U-Net, of max |logit|: cuDNN picks its
# FP32 algorithms (FFT and Winograd among them) per call, and GroupNorm
# divides each layer's rounding by its spread; two runs measured 2.9e-4 and
# 9.2e-4 (NVIDIA H100 80GB HBM3, 700 W).
SEG_TOL = 3e-3


def _unet_flops(model, H, W):
    """2 × the multiply-adds of the U-Net's convolutions in one forward pass
    over one H×W image (GroupNorm, ReLU, pooling and resize not counted)."""
    sizes = [(H, W), (H // 2, W // 2), (H // 4, W // 4), (H // 2, W // 2), (H, W)]
    total = 2 * model.head.weight.numel() * H * W
    for (h, w), blk in zip(sizes, model.blocks):
        total += 2 * (blk.conv0.weight.numel() + blk.conv1.weight.numel()) * h * w
    return total


def segmenter_phase(out_dir):
    """train_segmenter's Config function (``cli.train_segmenter.train``) at
    configs/xarm7_example.yaml's widths on the mini arm: 1280x720, f =
    1.2·1280, 6 ring cameras × 8 frames (radius 1.5, height 0.8), 600 steps
    of batch 4 at base 16, lr 1e-3. Prints the data generation's seconds and
    K4f launches, ms/step beside the step's FLOP bound, peak memory and the
    val IoU, and holds JAX's slow-test floors (final loss < 0.25, val IoU
    mean > 0.6, min > 0.5). Then the trained U-Net's logits on one frame on
    the card against a CPU copy. Returns (weights path, the K4f
    1280x720 kernels row, its launches, one camera's (Tc, K, frames), the
    runtime)."""
    import numpy as np
    import torch

    from easyhec_torch.cli import train_segmenter as ts
    from easyhec_torch.models import segmentation as seg
    from easyhec_torch.trainer import build_runtime

    cfg = iterative_config(SEG_STEPS, H=SEG_H, W=SEG_W)
    kernels = _all_kernels()
    got = {"gen_s": 0.0, "train_s": 0.0, "cams": []}
    real_gen, real_train = ts.generate_dataset, ts.train_segmenter

    def gen(out, chain, renderer, names, Tc, K, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = real_gen(out, chain, renderer, names, Tc, K, **kw)
        got["gen_s"] += time.perf_counter() - t0
        got["cams"].append((Tc, K, data))
        return data

    def train(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real_train(*a, **kw)
        torch.cuda.synchronize()
        got["train_s"] = time.perf_counter() - t0
        got["peak"] = torch.cuda.max_memory_allocated()
        return out

    weights = Path(out_dir) / "seg.pkl"
    ts.generate_dataset, ts.train_segmenter = gen, train
    _reset(kernels)
    try:
        report = ts.train(cfg, weights, n_cams=SEG_CAMS, frames_per_cam=SEG_FRAMES,
                          radius=1.5, height=0.8, steps=SEG_STEPS, seed=0, device=DEVICE)
    finally:
        ts.generate_dataset, ts.train_segmenter = real_gen, real_train
    launches = _launched(kernels)
    model = seg.UNet(16)
    fwd = _unet_flops(model, SEG_H, SEG_W)
    first = 2 * model.blocks[0].conv0.weight.numel() * SEG_H * SEG_W
    step_flops = 4 * (3 * fwd - first)  # fwd + dgrad + wgrad; no dgrad of the input
    ms = got["train_s"] / SEG_STEPS * 1e3
    bound = step_flops / FP32_OPS_PER_S * 1e3
    print(f"[segmenter] data: {SEG_CAMS} cameras x {SEG_FRAMES} frames of {SEG_W}x{SEG_H} in "
          f"{got['gen_s']:.3f} s "
          f"(render, depth pass, PNG writes), launches {json.dumps(launches)} ({GPU})")
    print(f"[segmenter] train: {SEG_STEPS} steps of batch 4 in {got['train_s']:.3f} s: "
          f"{ms:.3f} ms/step; conv FLOPs {fwd / 1e9:.3f} G per image forward, "
          f"{step_flops / 1e12:.4f} T per step (fwd + bwd) -> FP32 bound {bound:.3f} ms "
          f"({ms / bound:.2f}x); peak memory {got['peak'] / 2**30:.3f} GiB ({GPU})")
    print(f"[segmenter] report {json.dumps(report)}")
    if launches != {"sil_fwd": SEG_CAMS}:
        raise AssertionError(f"segmenter data: launches {launches}, not one K4f per camera")
    if not (report["final_loss"] < 0.25 and report["val_iou_mean"] > 0.6
            and report["val_iou_min"] > 0.5):
        raise AssertionError("segmenter below JAX's floors (loss 0.25, IoU 0.6 / 0.5)")

    # the trained U-Net's forward on one frame, card against a CPU copy
    state = seg._as_state(seg.load_params(weights))
    frame = got["cams"][0][2]["rgb"][0]
    logits = {}
    for d in (DEVICE, "cpu"):
        m = seg.UNet(16)
        m.load_state_dict(state)
        m.to(d).eval()
        with torch.no_grad():
            x = torch.as_tensor(frame, dtype=torch.float32, device=d)[None] / 255.0
            logits[d] = m(x)[0].cpu().numpy()
    diff = float(np.abs(logits[DEVICE] - logits["cpu"]).max())
    top = float(np.abs(logits["cpu"]).max())
    flips = int(((logits[DEVICE] > 0) != (logits["cpu"] > 0)).sum())
    print(f"[segmenter] one {SEG_W}x{SEG_H} frame, card vs cpu logits: max abs diff "
          f"{diff:.3e} of max |logit| {top:.3f} (tol {SEG_TOL} of it: cuDNN's algorithms), "
          f"{flips} mask pixels differ")
    if not diff <= SEG_TOL * top:
        raise AssertionError("U-Net logits on the card disagree with the CPU's")
    _segmenter_profile(got["cams"][0][2])
    rt = build_runtime(cfg, DEVICE)
    row = k4f_large_row(rt, *got["cams"][0])
    return weights, row, launches["sil_fwd"], got["cams"][0], rt


def _segmenter_profile(data, steps=5):
    """Where a training step's device time goes: ``steps`` steps (and their
    set-up) on one camera's frames under torch.profiler, the kernels ranked
    by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from easyhec_torch.models.segmentation import train_segmenter

    masks = (data["masks"] > 0.5).astype(np.float32)
    train_segmenter(data["rgb"], masks, steps=1, device=DEVICE)  # warm cuDNN
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_segmenter(data["rgb"], masks, steps=steps, device=DEVICE)
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and not e.key.startswith(("aten::", "cuda")):
            kern[e.key] = kern.get(e.key, 0.0) + e.self_device_time_total
    total = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    print(f"[segmenter] profile of {steps} steps: device {total / 1e3 / steps:.3f} ms/step; "
          + "; ".join(f"{k[:60]} {v / total:.3f}" for k, v in top) + f" ({GPU})")


def k4f_large_row(rt, Tc, K, data):
    """K4f at 1280x720: one ring camera's 8 frames on the dense state that
    RobotRenderer.silhouette builds there, against its plain version; its
    CUDA-event time, plain time and bytes/ops bound (the kernels row)."""
    import torch

    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.render.fused import build_fused_state, cam_rows

    r = rt.renderer
    Tc_t = torch.as_tensor(Tc, dtype=torch.float32, device=DEVICE)
    K_t = torch.as_tensor(K, dtype=torch.float32, device=DEVICE)
    qs = torch.as_tensor(data["qpos"], dtype=torch.float32, device=DEVICE)
    lp = rt.chain.fk(qs)[:, [rt.chain.link_index(n) for n in rt.link_names]]
    st = build_fused_state(r, Tc_t, lp, K_t)
    rec = pr._pad_records(st.rec, st.counts)
    counts = pr.i32(st.counts)
    Bf = counts.shape[0]
    cam = cam_rows(Tc_t, K_t, Bf).contiguous()
    c = r.tile
    meta = pr.Meta(c.tile_h, c.tile_w, -(-SEG_W // c.tile_w), SEG_H, SEG_W, 1.0, 0.001, 10.0,
                   c.bwd_band_only)
    sargs = (cam, rec, counts, meta)
    sk, _ = pr.sil_fwd_cuda(*sargs)
    spl, _ = pr.sil_fwd_plain(*sargs)
    err = (sk - spl).abs().max().item()
    print(f"[kernels 1280x720] K4f image, {Bf} frames: max abs err {err:.3e} (tol 1e-3, as "
          f"min(acc,2)); max tile count {int(st.counts.max())} (cap {c.capacity})")
    if not err <= 1e-3:
        raise AssertionError("K4f at 1280x720 disagrees with its plain version")
    w = _needed_work(cam, _dense_frames(rec, counts), {}, meta)
    _print_work("dense 1280x720", w)
    T, P = counts.shape[1], c.tile_h * c.tile_w
    nbytes = w["fwd"][1] * SLOT_BYTES + Bf * T * 4 + Bf * 64 + 2 * Bf * T * P * 4
    return _row("sil_fwd 1280x720", "K4f 1280x720", "easyhec_torch/ops/csrc/pose_raster.cu",
                "easyhec_tpu/ops/pose_raster.py:167", err, lambda: pr.sil_fwd_cuda(*sargs),
                lambda: pr.sil_fwd_plain(*sargs), nbytes,
                _ops(w["fwd"], OPS_FWD_PAIR, OPS_FWD_LANE), "pose_fwd_kernelILb0E",
                spill_free=True)


def seg_closed_loop_phase(weights, cam, rt, steps):
    """5 held-out frames from ring camera 0's view (seed 7): masks predicted
    by SegmenterMaskSource on the card, their IoU against the rendered GT,
    then ``calibrate`` on the compact route (xarm7_example's tiles and cap)
    from the GT perturbed as JAX's closed-loop test does, against JAX's
    limits (2 cm, 2 deg), with one K2f and one K2b launch per step. Returns
    the held-out frames [5, H, W, 3]."""
    import numpy as np
    import torch

    from easyhec_torch.data.synthetic import generate_dataset
    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.models.segmentation import SegmenterMaskSource, load_params

    Tc, K, _ = cam
    with tempfile.TemporaryDirectory() as tmp:
        held = generate_dataset(tmp, rt.chain, rt.renderer, rt.link_names, Tc, K,
                                n_frames=5, seed=7)
    src = SegmenterMaskSource(load_params(weights), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = np.stack([src.predict(f) for f in held["rgb"]])
    pred_s = (time.perf_counter() - t0) / len(pred)
    gt_m = held["masks"] > 0.5
    ious = [float((p.astype(bool) & m).sum() / max((p.astype(bool) | m).sum(), 1))
            for p, m in zip(pred, gt_m)]
    qs = torch.as_tensor(held["qpos"], dtype=torch.float32, device=DEVICE)
    lp = rt.chain.fk(qs)[:, [rt.chain.link_index(n) for n in rt.link_names]]
    init = se3.log(torch.from_numpy(np.asarray(Tc, np.float32))).numpy() + np.array(
        [0.02, -0.02, 0.02, 0.02, -0.02, 0.03], np.float32)
    kernels = _all_kernels()
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    res = calibrate(init, rt.renderer, lp, K, pred, num_steps=steps, max_lr=3e-3,
                    rebin_every=0, Tc_c2b_gt=Tc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _launched(kernels)
    m = res.metrics
    print(f"[seg closed loop] predict {pred_s * 1e3:.3f} ms/frame; per-frame IoU vs rendered GT "
          + ", ".join(f"{v:.4f}" for v in ious) + f" ({GPU})")
    print(f"[seg closed loop] calibrate on the predicted masks, {steps} steps in {dt:.3f} s "
          f"({dt / steps * 1e3:.3f} ms/step), {res.rebins} rebins; loss {res.losses[0]:.3f} -> "
          f"{res.losses[-1]:.3f}; error {m['err_trans_geodesic_cm']:.4f} cm, "
          f"{m['err_rot_geodesic_deg']:.4f} deg (limits 2, 2); launches {json.dumps(launches)}")
    if min(ious) <= 0.5:
        raise AssertionError("a held-out predicted mask is at IoU <= 0.5")
    if not (m["err_trans_geodesic_cm"] < 2.0 and m["err_rot_geodesic_deg"] < 2.0):
        raise AssertionError("closed loop on predicted masks misses 2 cm / 2 deg")
    if res.overflow or launches != {"loss_fwd_compact": steps, "loss_bwd_compact": steps}:
        raise AssertionError(f"closed loop: overflow, or launches {launches} for {steps} steps")
    return held["rgb"]


def annotate_phase(frames, weights):
    """cli/annotate on the held-out frames written by write_png: --auto with
    the saved weights, then --box/--point with the segmenter as the prompt
    backend; the masks, read back by read_png, must equal
    SegmenterMaskSource.predict (and PromptMasker's) bit for bit."""
    import numpy as np

    from easyhec_torch.cli import annotate
    from easyhec_torch.io.annotate import PromptMasker, Prompts
    from easyhec_torch.models.segmentation import SegmenterMaskSource, load_params
    from easyhec_torch.utils.imaging import read_png, write_png

    src = SegmenterMaskSource(load_params(weights), device=DEVICE)
    want = [src.predict(f) > 0.5 for f in frames]
    ys, xs = np.nonzero(want[0])
    box = [int(xs.min()) - 20, int(ys.min()) - 20, int(xs.max()) + 20, int(ys.max()) + 20]
    point = [int(xs[len(xs) // 2]), int(ys[len(ys) // 2]), 1]
    prompts = Prompts()
    prompts.add_box(*box)
    prompts.add_point(*point)
    want_p = [PromptMasker(backend=src).predict(f, prompts) > 0.5 for f in frames]
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "color").mkdir()
        for i, f in enumerate(frames):
            write_png(Path(tmp) / "color" / f"{i:06d}.png", f)
        secs = {}
        for mode, extra, ref in (("auto", [], want),
                                 ("box/point", ["--box", *map(str, box), "--point",
                                                *map(str, point), "--overwrite"], want_p)):
            t0 = time.perf_counter()
            rc = annotate.main(["--data-dir", tmp, "--auto", "--weights", str(weights),
                                "--device", DEVICE, *extra])
            secs[mode] = (time.perf_counter() - t0) / len(frames)
            got = [read_png(Path(tmp) / "mask" / f"{i:06d}.png") > 0 for i in range(len(frames))]
            same = all(np.array_equal(g, w) for g, w in zip(got, ref))
            print(f"[annotate] --{mode}: rc {rc}, {secs[mode]:.4f} s/frame for {len(frames)} "
                  f"frames of {SEG_W}x{SEG_H}; masks bit-equal to the segmenter's: {same} "
                  f"({sum(int(g.sum()) for g in got)} px set) ({GPU})")
            if rc != 0 or not same:
                raise AssertionError(f"annotate --{mode}: masks differ from the predictions")


def diagnose_phase(cfg, batch, steps=500):
    """cli/diagnose on the trainer phase's batch (dense route: K1f/K1b fits,
    K4f renders) with frames 2 and 5's qposes swapped: baseline, robust and
    --repair, which must re-pair exactly those two and beat the baseline's
    mIoU; the three artifacts and the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from easyhec_torch.cli.diagnose import diagnose

    perm = np.arange(batch.n_frames)
    perm[[2, 5]] = [5, 2]
    swapped = dataclasses.replace(batch, qpos=batch.qpos[perm], link_poses=batch.link_poses[perm])
    out = Path(cfg.output_dir) / "diagnose"
    kernels = _all_kernels()
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    report = diagnose(copy.deepcopy(cfg), out, batch=swapped, steps=steps, repair=True,
                      device=DEVICE)
    dt = time.perf_counter() - t0
    launches = _launched(kernels)
    rep = report["repair"]
    tail = "repair_exclude" in report
    fits, renders = 3 + tail, 3 + 2 * tail
    arts = [f for f in ("report.json", "report.md", "overlays.png") if (out / f).is_file()]
    print(f"[diagnose] {batch.n_frames} frames of {W}x{H}, frames 2 and 5 swapped, {steps} "
          f"steps a fit: {dt:.3f} s; baseline mIoU {report['baseline']['mean_iou']:.4f}, "
          f"robust {report['robust']['mean_iou']:.4f}, repair {rep['mean_iou']:.4f} with "
          f"assignment {rep['assignment_mask_to_qpos']}; exclude tail {tail}; artifacts "
          f"{arts}; launches {json.dumps(launches)} ({GPU})")
    if rep["assignment_mask_to_qpos"] != perm.tolist():
        raise AssertionError("diagnose --repair did not re-pair exactly frames 2 and 5")
    if not rep["mean_iou"] > report["baseline"]["mean_iou"] or len(arts) != 3:
        raise AssertionError("diagnose: the repair's mIoU is not above the baseline's, "
                             "or an artifact is missing")
    want = {"loss_fwd": fits * steps, "loss_bwd": fits * steps, "sil_fwd": renders}
    if launches != want:
        raise AssertionError(f"diagnose launches {launches}, expected {want}")


def lr_finder_phase(renderer, lp, K, xi, target, steps=100):
    """find_lr (Adam, 100 steps from 1e-6 to 1) over the compact calibration
    loss at the bench scene on one bin state built at the start pose: one
    K2f and one K2b launch per step and a finite suggestion."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import mask_loss, tile_masks
    from easyhec_torch.solver.lr_finder import find_lr

    d0 = (xi + 0.01).detach()
    st = renderer.bin_state(se3.exp(d0), lp, K)
    ref = tile_masks(target, renderer)
    kernels = _all_kernels()
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    res = find_lr(lambda d: mask_loss(d, renderer, lp, K, target, bin_state=st, ref_tiles=ref),
                  d0, num_steps=steps)
    dt = time.perf_counter() - t0
    launches = _launched(kernels)
    print(f"[lr_finder] {steps} Adam steps in {dt:.3f} s ({dt / steps * 1e3:.3f} ms/step): "
          f"suggestion {res.suggestion:.4e}, diverged at {res.diverged_at}, loss "
          f"{res.losses[0]:.3f} -> min {np.nanmin(res.losses):.3f}; launches "
          f"{json.dumps(launches)} ({GPU})")
    if not np.isfinite(res.suggestion) or launches != {"loss_fwd_compact": steps,
                                                      "loss_bwd_compact": steps}:
        raise AssertionError(f"lr_finder: suggestion {res.suggestion}, launches {launches}")


def profiling_phase(renderer, lp, K, xi, target, steps=5):
    """EvalTimer probes with a CUDA sync around a mask loss, and a
    torch.profiler trace around 5 compact calibrate steps (the Chrome trace
    must exist and hold the K2 kernels)."""
    import torch

    from easyhec_torch.models.calib import calibrate, mask_loss
    from easyhec_torch.utils.profiling import TRACE_NAME, EvalTimer, trace

    d0 = (xi + 0.01).detach()
    timer = EvalTimer()
    timer("start")
    loss = mask_loss(d0, renderer, lp, K, target)
    timer("mask_loss", sync=loss)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            calibrate(d0.cpu().numpy(), renderer, lp, K, target, num_steps=steps, max_lr=3e-3,
                      rebin_every=0)
        timer("calibrate (traced)", sync=loss)
        text = (Path(tmp) / TRACE_NAME).read_text()
    print(f"[profiling] EvalTimer {json.dumps(timer.summary())} s; trace of {steps} calibrate "
          f"steps: {len(text)} bytes, K2f named in it {text.count('loss_fwd_compact_kernel')} "
          f"times ({GPU})")
    if "loss_fwd_compact_kernel" not in text or "mask_loss" not in timer.summary():
        raise AssertionError("profiling: the trace holds no K2f, or a probe is missing")


def watch_phase(run_dir):
    """utils.live.serve (cli/watch's server) in the background on the
    trainer's run dir, on a free local port: /api/ls lists images/ and
    live.html is served."""
    import socket
    import urllib.request

    from easyhec_torch.utils.live import DASHBOARD_NAME, serve, write_dashboard

    write_dashboard(run_dir)
    with socket.socket() as sck:
        sck.bind(("127.0.0.1", 0))
        port = sck.getsockname()[1]
    srv = serve(run_dir, port=port, background=True)
    try:
        base = f"http://127.0.0.1:{port}"
        ls = json.loads(urllib.request.urlopen(f"{base}/api/ls", timeout=10).read())
        page = urllib.request.urlopen(f"{base}/{DASHBOARD_NAME}", timeout=10).read()
    finally:
        srv.shutdown()
        srv.server_close()
    want = sorted(p.name for p in (Path(run_dir) / "images").glob("*.png"))
    print(f"[watch] /api/ls on the trainer run dir: {len(ls)} images; {DASHBOARD_NAME} "
          f"{len(page)} bytes")
    if ls != want or b"easyhec_torch live" not in page:
        raise AssertionError("watch: /api/ls or the dashboard is wrong")


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


def silhouette_path(renderer, lp, K, xi, target, kernels, label, steps=20):
    """Adam steps on mean Σ(RobotRenderer.silhouette − mask)² through
    autograd: the image-route loss (easyhec_tpu's sharded calibration
    differentiates the silhouette so). Each step re-bins (no bin state
    passed). kernels {name: wrapper}: the pair that must launch once per
    step (dense route: K4f and K4b; the unfused route's top-k binner: K5f
    and the dense K5b)."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.solver.optim import make_optimizer

    opt = make_optimizer("adam", max_lr=3e-3)
    dof = (xi + 0.01).clone()
    state = opt.init(dof)
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
    print(f"[{label}] {steps} image-loss steps through RobotRenderer.silhouette: "
          f"{dt / steps * 1e3:.3f} ms/step with a rebin each; loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}; launches {json.dumps(launches)}")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: the image loss did not fall")
    if launches != {k: steps for k in kernels}:
        raise AssertionError(f"{label}: launches {launches} for {steps} steps")
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


# The online loop at configs/xarm7_example.yaml's widths (the xArm7 assets
# are not in the repo: the mini arm at 8 mm edges stands in for it).
ITER_H, ITER_W, ITER_F = 720, 1280, 906.8


def iterative_config(steps, H=ITER_H, W=ITER_W, rounds=5, n_sample=1000, n_hyp=10,
                     history_start=200):
    """An in-memory Config with xarm7_example's render, solver and explorer
    settings (the GPU machine has no PyYAML), on the mini arm."""
    from easyhec_torch.config import Config

    cfg = Config()
    m, r, s, e = cfg.model, cfg.render, cfg.solver, cfg.explorer
    m.urdf_path = str(ROOT / "assets" / "mini_arm.urdf")
    m.use_links = ["base", "upper", "fore"]
    m.H, m.W, m.subdivide_max_edge, m.decimate_voxel = H, W, 0.008, 0.004
    r.tile_h, r.tile_w, r.capacity, r.rect_y, r.rect_x = 16, 32, 1664, 8, 5
    r.cull_backfaces, r.bin_big_k, r.bin_subsort_rows, r.compact_chunks = True, 3840, True, 384
    s.num_epochs, s.max_lr, s.explore_iters, s.rebin_every = steps, 3e-3, rounds, 0
    e.n_sample_qposes, e.n_hypotheses, e.history_start = n_sample, n_hyp, history_start
    e.render_downscale, e.plan_top_k = 2, 10
    e.self_collision_check, e.use_workspace_boundary = True, True
    cfg.dataset.data_dir = ""
    return cfg


def iterative_rig(H=ITER_H, W=ITER_W, f=ITER_F):
    """(GT camera-from-base [4, 4], K [3, 3]) as numpy: the bench scene's
    look_at, and K with the focal length of xarm7_example's header."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import camera, se3

    Tcam = camera.look_at(torch.tensor([1.0, 0.7, 0.8]), torch.tensor([0.0, 0.0, 0.3]),
                          torch.tensor([0.0, 0.0, 1.0]))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return se3.inverse(Tcam).numpy(), K


def iterative_phase(steps):
    """``run_iterative`` on the card as a simulated closed loop (SimArm,
    SimCamera, RendererMaskSource) at xarm7_example's widths: 5 rounds of
    capture, ``calibrate`` over every frame so far (K2f/K2b), explore (1000
    candidates × 10 hypotheses scored through K3 at 640×360) and plan (RRT
    with the self-collision spheres and the workspace cloud). The captures
    render through K4f. Per round it prints the frames, the loss, the pose
    error, the seconds of each part and the explorer's statistics, and it
    holds K3's launches per _score to ⌈C / score_batch⌉ × n_hypotheses per
    scoring pass. Returns (launches, the round-1 explore call's inputs)."""
    import math
    import tempfile

    import numpy as np
    import torch

    from easyhec_torch.cli.run import perturbed_start
    from easyhec_torch.io.interfaces import SimCamera
    from easyhec_torch.models.explorer import SpaceExplorer
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.trainer import iterative as itr

    cfg = iterative_config(steps)
    gt, K = iterative_rig()
    cfg.model.init_Tc_c2b = perturbed_start(gt, cfg.solver.seed)
    counters = {"K2f/K3": prc.loss_fwd_compact_cuda, "K2b": prc.loss_bwd_compact_cuda,
                "K4f": pr.sil_fwd_cuda}
    rounds, explore_in = [], {}

    def snap():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in counters.items()}, time.perf_counter()

    def delta(s0):
        s1, t1 = snap()
        return {k: s1[k] - s0[0][k] for k in s1}, t1 - s0[1]

    real = (SimCamera.capture, SpaceExplorer.explore, itr.calibrate, itr.plan_first_feasible)

    def capture(self):
        s0 = snap()
        out = real[0](self)
        d, dt = delta(s0)
        rounds.append({"K4f": d["K4f"], "capture_s": dt, "calibrate_s": 0.0, "K2f": 0,
                       "K2b": 0, "explore_s": 0.0, "K3": 0, "plan_s": 0.0})
        return out

    def calibrate(*a, **kw):
        s0 = snap()
        try:
            res = real[2](*a, **kw)
        finally:
            d, dt = delta(s0)
            rounds[-1]["calibrate_s"] += dt
            rounds[-1]["K2f"] += d["K2f/K3"]
            rounds[-1]["K2b"] += d["K2b"]
        rounds[-1].update(frames=len(a[4]), res=res)
        return res

    def explore(self, history, K_e, key=0, **kw):
        s0 = snap()
        res = real[1](self, history, K_e, key=key, **kw)
        d, dt = delta(s0)
        rounds[-1].update(explore_s=dt, K3=d["K2f/K3"], explore=res, shared=self.last_shared,
                          spread=self.last_spread_px, esc=self.last_escalations,
                          max_load=self.last_max_load, bin_states=self.last_bin_states,
                          cap=self.renderer.tile.capacity)
        if key == 1:
            explore_in.update(explorer=self, history=np.asarray(history), K=np.asarray(K_e))
        return res

    def plan(*a, **kw):
        t0 = time.perf_counter()
        out = real[3](*a, **kw)
        rounds[-1]["plan_s"] = time.perf_counter() - t0
        rounds[-1]["planned"] = out[0] is not None
        return out

    print(f"[iterative] {cfg.solver.explore_iters} rounds of {steps} steps (xarm7_example: "
          f"1000), {ITER_W}x{ITER_H} f={ITER_F}, scoring "
          f"{cfg.explorer.n_sample_qposes}x{cfg.explorer.n_hypotheses} at 1/"
          f"{cfg.explorer.render_downscale}; {GPU}")
    with tempfile.TemporaryDirectory() as tmp:
        cfg.output_dir = tmp
        SimCamera.capture, SpaceExplorer.explore = capture, explore
        itr.calibrate, itr.plan_first_feasible = calibrate, plan
        _reset(counters)
        t0 = time.perf_counter()
        try:
            res = itr.run_iterative(cfg, Tc_c2b_gt=gt, K=K, device=DEVICE)
        finally:
            SimCamera.capture, SpaceExplorer.explore, itr.calibrate, \
                itr.plan_first_feasible = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        totals = {k: fn.launches for k, fn in counters.items()}
        out = Path(tmp)
        n_caps = len(list((out / "captures" / "mask").glob("*.png")))
        n_ckpt = len(list((out / "checkpoints").glob("round_*.npz")))
    C, Hh = cfg.explorer.n_sample_qposes, cfg.explorer.n_hypotheses
    per_score = math.ceil(C / 5) * Hh  # the explorer's default score_batch of 5
    for i, r in enumerate(rounds):
        m = r["res"].metrics
        line = (f"[iterative] round {i}: {r['frames']} frames, loss {r['res'].losses[0]:.3f} "
                f"-> {r['res'].losses[-1]:.3f}, error {m['err_trans_geodesic_cm']:.4f} cm "
                f"{m['err_rot_geodesic_deg']:.4f} deg, {r['res'].rebins} rebins; seconds: "
                f"capture {r['capture_s']:.3f}, calibrate {r['calibrate_s']:.3f}, explore "
                f"{r['explore_s']:.3f}, plan {r['plan_s']:.3f}; launches K2f {r['K2f']} "
                f"K2b {r['K2b']} K3 {r['K3']} K4f {r['K4f']}")
        if "explore" in r:
            e = r["explore"]
            line += (f"; explorer: variance {e.variance:.3f}, {int(e.feasible.sum())}/"
                     f"{len(e.feasible)} feasible, {'shared' if r['shared'] else 'exact'} "
                     f"(spread {r['spread']:.2f} px), {r['esc']} escalations, max tile load "
                     f"{r['max_load']} (cap {r['cap']}), {r['bin_states']} bin states and "
                     f"{r['K3']} K3 launches ({r['K3'] / (1 + r['esc']):.0f} per _score)")
            if r["K3"] != (1 + r["esc"]) * per_score:
                raise AssertionError(f"round {i}: {r['K3']} K3 launches for {1 + r['esc']} "
                                     f"scoring passes of {per_score}")
            if r["bin_states"] != per_score // (Hh if r["shared"] else 1):
                raise AssertionError(f"round {i}: {r['bin_states']} bin states per _score")
        line += f"; planned {r.get('planned')}"
        print(line)
    m = res.metrics
    launches = {"K2f": sum(r["K2f"] for r in rounds), "K2b": totals["K2b"],
                "K3": sum(r["K3"] for r in rounds), "K4f": totals["K4f"]}
    print(f"[iterative] {wall:.3f} s in all: calibrate {sum(r['calibrate_s'] for r in rounds):.3f}"
          f", explore {sum(r['explore_s'] for r in rounds):.3f}, plan "
          f"{sum(r['plan_s'] for r in rounds):.3f}, capture "
          f"{sum(r['capture_s'] for r in rounds):.3f}; final error "
          f"{m['err_trans_geodesic_cm']:.4f} cm {m['err_rot_geodesic_deg']:.4f} deg (limits "
          f"1.5 cm, 1.5 deg); launches {json.dumps(launches)}; {n_caps} captures, {n_ckpt} "
          f"round checkpoints ({GPU})")
    if launches["K2f"] + launches["K3"] != totals["K2f/K3"]:
        raise AssertionError("compact forward launches outside calibrate and explore")
    if not (m["err_trans_geodesic_cm"] < 1.5 and m["err_rot_geodesic_deg"] < 1.5):
        raise AssertionError(f"the online loop ended at {m}")
    if n_caps != len(rounds) or n_ckpt != len(rounds) or len(rounds) != 5:
        raise AssertionError(f"{len(rounds)} rounds, {n_caps} captures, {n_ckpt} checkpoints")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the online loop never launched: {launches}")
    return launches, explore_in, len(rounds) - 1


def explore_kernel_phase(explore_in, launches_k3, n_explored):
    """K3 (compact_tile_acc) at the explorer's scoring shape: the first batch
    of 5 candidates of round 1's draw, at the first of its hypotheses, on
    the explorer's renderer (640×360, doubled budgets). Against its plain
    version, twice bit for bit, timed, bounded by the work this data needs.
    Returns its kernels-line row."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models import explorer as ex
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.render.fused import cam_rows
    from easyhec_torch.render.tiled import _cdiv

    e = explore_in["explorer"]
    r, t = e.renderer, e.renderer.tile
    hist = explore_in["history"]
    hist = hist[min(e.history_start, max(len(hist) - 1, 0)):]
    lim = np.asarray(e.chain.joint_limits, np.float32) * np.float32(e.limit_fraction)
    sel, qs = ex.draw_hypotheses_and_candidates(1, e.n_hypotheses, len(hist),
                                                e.n_sample_qposes, lim[:, 0], lim[:, 1])
    dev = r.device
    Th = se3.exp(torch.tensor(hist[sel[0]], device=dev))
    K = torch.tensor(explore_in["K"], device=dev)
    lp = e.chain.fk(torch.tensor(qs[: e.score_batch], device=dev))
    lp = lp[:, torch.as_tensor(e.link_idx, device=dev).long()]
    st = r.bin_state(Th, lp, K)
    Bs, T = st.counts.shape
    n_tx = _cdiv(r.W, t.tile_w)
    cam = cam_rows(Th, K, Bs).contiguous()
    meta = prc.Meta(t.tile_h, t.tile_w, n_tx, r.H, r.W)
    zeros = torch.zeros((Bs, T, t.tile_h, t.tile_w), device=dev)

    def run():
        return prc.compact_tile_acc(cam, st.rec, st.nlive, st.ctmap, st.ncu, T, t.tile_h,
                                    t.tile_w, n_tx, r.H, r.W)

    def plain():
        return prc.loss_fwd_compact_plain(cam, st.rec, st.nlive, st.ctmap, st.ncu, zeros,
                                          meta)[1]

    acc_k, acc_p = run(), plain()
    err = (acc_k.clamp(max=2) - acc_p.clamp(max=2)).abs().max().item()
    print(f"[kernels explore] K3 at the scoring shape: {Bs} frames of {r.W}x{r.H}, tiles "
          f"{t.tile_h}x{t.tile_w} (T = {T}), cap {t.capacity}, nc {t.compact_chunks}; loads "
          f"max tile {int(st.counts.max())}, max ncu {int(st.ncu.max())}, overflow "
          f"{bool(st.overflow)}; min(acc, 2) max abs err {err:.3e} (tol 1e-3, as for K2f)")
    if bool(st.overflow) or not err <= 1e-3:
        raise AssertionError("K3 at the scoring shape overflows or disagrees with its plain "
                             "version")
    _check_repeat("K3 explore", lambda: run().clamp(max=2))
    frames = [(prc._chunks_of(st.rec[b]), st.ctmap[b].long(), st.nlive[b].long())
              for b in range(Bs)]
    w = _needed_work(cam, frames, {}, meta)
    _print_work("explore K3", w)
    P, nc = t.tile_h * t.tile_w, st.nlive.shape[1]
    row = _row("compact_tile_acc", "K3 explore", "easyhec_torch/ops/csrc/pose_raster_compact.cu",
               "easyhec_tpu/ops/pose_raster_compact.py:201", err, run, plain,
               # records of the live slots in, acc out, the chunk map and cams
               w["fwd"][1] * SLOT_BYTES + Bs * T * P * 4 + Bs * (nc * 8 + 4 + 64),
               _ops(w["fwd"], OPS_FWD_PAIR, OPS_FWD_LANE), "loss_fwd_compact_kernel",
               spill_free=True)
    per_round = launches_k3 / n_explored
    # One scoring pair (a bin state and its K3 render): CUDA-event time queued
    # behind a device sleep (paced by the host once the host's time per pair
    # exceeds the card's), host time of synchronized pairs, and the device
    # busy time the profiler sums.
    rebin_ms = _time_ms(lambda: r.bin_state(Th, lp, K), 20)
    pair_ms = _time_ms(lambda: run() if r.bin_state(Th, lp, K) is not None else None, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        r.bin_state(Th, lp, K)
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    busy_ms = _busy_ms(lambda: (r.bin_state(Th, lp, K), run()), 20)
    print(f"[kernels explore] K3 launches in the online loop: {launches_k3} ({per_round:.0f} "
          f"per explored round); {row['ms'] * per_round / 1e3:.3f} s of K3 device time per "
          f"round; one scoring pair: rebin {rebin_ms:.4f} ms and rebin + K3 {pair_ms:.4f} ms "
          f"by CUDA events, {host_ms:.4f} ms on the host clock, so "
          f"{pair_ms * per_round / 1e3:.3f} s by events and {host_ms * per_round / 1e3:.3f}"
          f" s of host time per round ({GPU})")
    print(f"[kernels explore] one scoring pair's device busy time (torch.profiler, the sum "
          f"of its device ops): {busy_ms:.4f} ms, {busy_ms * per_round / 1e3:.3f} s per round "
          f"({GPU})")
    return row


def reference_explore():
    """SpaceExplorer._score on the card against device="cpu" on a small
    compact scene (the mini arm at 96×128, 16 candidates × 4 hypotheses,
    batches of 5), identical inputs. The variance is held to 1e-4 of its
    largest value (the parity tests' limit against JAX), feasibility must
    be equal, and the argmax where the best two are further apart than
    that limit."""
    import numpy as np
    import torch

    from easyhec_torch.models.explorer import (
        SpaceExplorer, build_link_spheres, draw_hypotheses_and_candidates,
    )
    from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf

    model = parse_urdf(ROOT / "assets" / "mini_arm.urdf")
    chain = build_chain(model)
    names = ["base", "upper", "fore"]
    spheres = build_link_spheres(chain, load_link_meshes(model, link_names=names))
    lim = chain.joint_limits * np.float32(0.9)
    out = {}
    for dev in (DEVICE, "cpu"):
        r, lp, K, xi, _ = build_scene(dev, H=96, W=128, B=1, max_edge=0.04, cap=512, nc=32)
        if not out:
            hyp = (xi.cpu().numpy() + np.random.default_rng(0).normal(0, 0.01, (4, 6))
                   ).astype(np.float32)
            _, qs = draw_hypotheses_and_candidates(0, 4, 4, 16, lim[:, 0], lim[:, 1])
        e = SpaceExplorer(chain, r, names, spheres=spheres, max_dist=0.37)
        out[dev] = [a.cpu().numpy() for a in e._score(qs, hyp, K.cpu().numpy())]
    (vk, fk, ok), (vp, fp, op) = out[DEVICE], out["cpu"]
    fin = np.isfinite(vp)
    vmax = np.abs(vp[fin]).max()
    rel = np.abs(vk[fin] - vp[fin]).max() / vmax
    top = np.sort(vp[fin])[::-1]
    gap = (top[0] - top[1]) / vmax
    same = int(np.argmax(vk)) == int(np.argmax(vp))
    print(f"[reference explore] _score cuda vs cpu, 16 candidates x 4 hypotheses at 128x96: "
          f"variance max rel diff {rel:.3e} (tol 1e-4), feasible equal "
          f"{np.array_equal(fk, fp)} ({int(fp.sum())}/16), argmax equal {same} (best-two gap "
          f"{gap:.3e} of max), overflow {bool(ok)} / {bool(op)}")
    if not (np.array_equal(fk, fp) and np.array_equal(np.isfinite(vk), fin) and rel <= 1e-4):
        raise AssertionError("the card's _score disagrees with the CPU's")
    if gap > 1e-4 and not same:
        raise AssertionError("the card's _score picks another candidate")


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
                    help="replay the compact, dense and unfused calibrate runs under "
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
    global GPU
    gpu = GPU = _gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops import tile_raster as tr
    from easyhec_torch.render import RobotRenderer
    from easyhec_torch.render.fused import cam_rows, silhouette_compact

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

    check_tile_acc("16x32", cam_rows(se3.exp(xi), K, B).contiguous(), st_gt, TH, TW)
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
                                       "tile_bwd_counted": tr.tile_bwd_counted_cuda},
                                      "main unfused")
    if unf_launches != {"tile_fwd": args.steps, "tile_bwd_counted": args.steps}:
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
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    trainer_launches, _, trainer_cfg, trainer_batch = trainer_phase(
        lp, K, xi, qs, target_d, args.steps, work / "trainer")
    sil_launches = silhouette_path(dense, lp, K, xi, target_d,
                                   {"sil_fwd": pr.sil_fwd_cuda, "sil_bwd": pr.sil_bwd_cuda},
                                   "silhouette")
    topk = RobotRenderer(renderer.meshes, H, W, device=DEVICE,
                         tile=unfused.tile._replace(binner="topk"))
    topk_launches = silhouette_path(topk, lp, K, xi, target_u,
                                    {"tile_fwd": tr.tile_fwd_cuda, "tile_bwd": tr.tile_bwd_cuda},
                                    "silhouette topk", steps=5)
    launches["tile_bwd"] = topk_launches["tile_bwd"]
    launches.update({k: trainer_launches[k] for k in ("loss_fwd", "loss_bwd", "sil_fwd")})
    launches["sil_bwd"] = sil_launches["sil_bwd"]
    res = search_phase(renderer, lp, K, xi, target)
    search_kernel_phase(renderer, lp, K, target, res)
    trainer_search_phase(lp, K, xi, qs, target, args.steps)
    iter_launches, explore_in, n_explored = iterative_phase(args.steps)
    kernels.append(explore_kernel_phase(explore_in, iter_launches["K3"], n_explored))
    launches["compact_tile_acc"] = iter_launches["K3"]
    schedules_phase(renderer, lp, K, xi, target, args.steps)
    option_routes_phase(renderer, lp, K, xi)
    xla_tiled_phase(renderer, lp, K, xi, target)
    ring_phase(renderer, K)
    validate_phase(trainer_cfg, trainer_batch)
    tune_init_phase(trainer_cfg, trainer_batch, xi)
    pnp_phase(renderer, lp, K, xi)
    weights, k4f_row, k4f_launches, cam0, seg_rt = segmenter_phase(work)
    kernels.append(k4f_row)
    launches["sil_fwd 1280x720"] = k4f_launches
    held = seg_closed_loop_phase(weights, cam0, seg_rt, args.steps)
    annotate_phase(held, weights)
    diagnose_phase(trainer_cfg, trainer_batch)
    lr_finder_phase(renderer, lp, K, xi, target)
    profiling_phase(renderer, lp, K, xi, target)
    watch_phase(trainer_cfg.output_dir)
    shutil.rmtree(work)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    reference_check(32)
    reference_check(0)
    reference_check(0, fused=False)
    reference_search()
    reference_explore()

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
