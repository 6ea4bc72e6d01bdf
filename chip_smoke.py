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
   unfused routes, 1000 steps each, each step a replay of one CUDA graph
   captured once per call, the rebin a conditional node inside it that the
   device takes when the probes drift past the budget; the host reads once
   per chunk of 50. Asserts no overflow, a falling loss, and one loss (or
   K5f and counted K5b) kernel pair launch per step (the wrappers' counters
   count replays). ``[main eager]``: the same scene and
   calibrate loop, graphed then eager (``utils.cuda_graph.captures``, the
   one place that says whether the card runs graphs, patched to refuse), five
   turns on the compact and dense routes: traces bit-identical, ms/step
   median and spread of each, the capture's seconds by part, each runner's peak
   memory and host reads per chunk (graphed: only the read after it)
   (tests/test_torch_cuda.py holds the unfused route's graphs too).
   ``[behaviour]``: each route's analytic pose gradient (K2b, K1b, the
   counted K5b) against central differences of its own forward at xi +
   0.01, with the JAX package's rule (tests/test_fused.py:173-188: each
   component within max(12 % of the FD component, 3 % of max|g|), eps
   1e-4), after the spread of repeated forwards and the FD at eps 1e-4 and
   1e-3; then the capture profile: the compact route's calibrate, 1000
   steps from xi + m·d for m in (0.05, 0.1, 0.15, 0.3), d from numpy's
   default_rng(7): each final error, 0.05 converged (1 cm, 1 deg) and the
   basin not inverted, as the JAX package's profile test asserts.
4. Dense trainer: ``run_offline_calibration`` with an in-memory Config and
   CalibBatch. Asserts no overflow, a falling loss, one K1f and one K1b
   launch per step, one K4f launch per render_outputs call, the artifacts.
5. Silhouette gradient paths: Adam steps on Σ(RobotRenderer.silhouette −
   mask)² through autograd: one K4f and one K4b launch per step on the
   dense route; one K5f and one dense K5b per step on the unfused route's
   top-k binner (binner="topk").
6. Global search: ``global_search_init`` at its defaults on frame 0 (K5f
   251 launches, the counted K5b 200), graphed (the sweep one CUDA graph
   replayed per batch of 64, the moment refine one graph, the Adam step
   one graph replayed per step) and, as ``[search eager]``, eagerly
   (``utils.cuda_graph.captures`` patched to refuse), three turns each: bit
   for bit, seconds median and spread, capture seconds by stage, peak
   memory, then seconds and device span by stage and the graphed run's
   host reads; then K5f and both K5b timed against their plain versions
   at its sweep and refinement batches; then ``run_offline_calibration``
   on the compact route with init_method="global_search" (the overflow
   pre-check adds one K5f), graphed then eager, bit for bit.
7. The online loop: ``run_iterative`` as a simulated closed loop at
   configs/xarm7_example.yaml's widths (1280x720, f = 906.8, its render,
   solver and explorer settings, 5 rounds) on the mini arm: per round the
   frames, loss, pose error, the seconds of capture, calibrate, explore
   and plan, the explorer's statistics and the launches of K2f, K2b, K3
   and K4f. Asserts the final error under 1.5 cm and 1.5 deg and K3's
   launches per scoring pass; each scoring pass replays one CUDA graph per
   batch of 5 candidates. Then K3 at the explorer's scoring shape (5
   frames of 640x360) against its plain version, with one scoring pair's
   CUDA-event time (host-paced), host time and device busy time (the
   profiler's sum of its device ops); ``[explore eager]``: round 1's
   scoring pass on its first 200 candidates graphed, then eager, bit for
   bit, with the seconds of each. ``[binner]`` and ``[rebin]``: a bin
   state's binner, triangle setup and compact pack at the benchmark cells'
   shapes against their plain versions, bit for bit (kernels-line rows),
   and the whole bin state's device time. The binner launches once per bin
   build on every route and in every explore round, the setup once per
   fused bin build and the pack once per compact one. ``[step]``: the
   calibration step's head, grad and update kernels (ops/step.py) at the
   calib cell's and the rig band's shapes against their plain twins
   (kernels-line rows); ``[main compact]``, ``[main dense]`` and
   ``[parallel nccl]`` hold them to one grad and one update a step, one head
   a step and a rebin, and ``kernel_steps`` to the steps.
8. The remaining options and offline tools. ``[schedules]``: the compact
   route's calibrate under warmup_cosine (100 warmup steps), its lr at
   four steps against the closed form, one K2f/K2b pair per step.
   ``[optimizer groups]``: make_optimizer over the U-Net's parameter tree
   (base 16, 118,913 params, 21 bias leaves) under grad_clip_value,
   weight_decay, bias_lr_factor, weight_decay_bias and all of them (adam;
   sgd with all), 20 steps, card against CPU.
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
   Adam steps, one K2f/K2b pair a step, graphed (one step graph replayed
   per step) and eager (``utils.cuda_graph.captures`` patched), three turns
   each: losses bit for bit, ms/step median and spread. ``[profiling]``: EvalTimer with a
   CUDA sync and a torch.profiler trace of 5 calibrate steps. ``[watch]``:
   utils.live.serve answering /api/ls on the trainer's run dir, which
   holds its mid-run panels (an error_map and a rendered PNG every
   log_interval steps) and error_maps.png, written without matplotlib.
10. Multi-device (easyhec_torch.parallel). ``[parallel nccl]``: an NCCL
   process group of one rank and the (1, 1) DeviceMesh; sharded_calibrate,
   graphed, against calibrate on the bench scene's compact route (1000
   steps each, JAX's early-trace tolerance, one K2f/K2b pair per step) and
   against itself eager, bit for bit; one NCCL all_reduce captured in a
   CUDA graph and replayed.
   ``[parallel 2x2]`` at config (5)'s widths (scripts/config5_chip.py: 4
   ring views x 20 frames of 1920x1080, f = 1400, the view offsets folded
   into the link poses) on the mini arm: the bin audit (printed) sets the
   caps; ``[parallel band kernels]`` holds K2f, K2b and K3 on the second
   540-row band (cy shifted by 540) against their plain versions (kernels-
   line rows); calibrate of the 80 frame-views on this process, then 4
   gloo ranks on the one card, each its own process (``--parallel-worker``),
   on a (2 data x 2 tile) mesh, 1000 steps of sharded_calibrate: ranks
   bit-identical, each rank's launches, ms/step against the one rank's,
   peak memory, rebins, the gloo all-reduce's share of a step.
   ``[parallel comm]``: all_gather_arrays, all_gather_objects, reduce_dict
   and sync across the 4 ranks.
11. The command-line tools (``[cli]``): each CLI as a user runs it,
   ``python -m easyhec_torch.cli.<name>`` in a fresh interpreter from the
   checkout's root, with no --device flag and PyYAML, JAX, optax,
   easyhec_tpu, OpenCV and matplotlib blocked, so configs/*.yaml go through
   the port's own YAML reader: configs/sim_mini.yaml's simulate and run as
   the README gives them (dense route, 240x320, 400 steps), then
   configs/xarm7_example.yaml at its widths on the mini arm: simulate (10
   frames of 1280x720), run with its global-search init, run from the
   perturbed GT passed as a nested flow list (1.5 cm, 1.5 deg), validate,
   tune_init --global-search, simulate --ring 8, run --iterative (2 rounds;
   1.5 cm, 1.5 deg), train_segmenter (2 x 4 frames, 50 steps), annotate
   --auto and diagnose (100 steps). Each prints its rc, seconds, held line,
   kernel launches and artifacts; no child may rebuild a kernel library.
12. Reference checks on small inputs, compact, dense and unfused, a small
   global search and a small explorer scoring pass: the card against the
   plain versions on the CPU.

Prints the kernel table as one JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. With --profile DIR it
also replays the compact, the dense and the unfused ``calibrate`` runs
under torch.profiler (the graph captured before the trace starts) and
writes each run's device busy share, device ops a step and per-step
breakdown into DIR; the rebin's device time is read from its conditional
body captured alone and replayed.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
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


def check_tile_acc(tag, cam, st, th, tw, H=H, W=W):
    """compact_tile_acc (K3: the compact forward kernel with a zero
    reference, which renders the target masks) against the plain forward
    on the compact bin state st of th x tw tiles of an H x W image."""
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
    run once per step. The binner must launch once per bin build, the
    triangle setup once per bin build of a fused route and the compact pack
    once per bin build of the compact route; on a fused route the step
    kernels (_check_step_kernels) once a step, the head once more a rebin,
    and calib.call's kernel_steps the steps. Returns (launches by name, the
    binner's under "bin_count", the setup's under "tri_setup", the pack's
    under "compact_pack", the step kernels' under their names; ms/step;
    rebins)."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.ops.binning import bin_count_cuda
    from easyhec_torch.ops.rebin import compact_pack_cuda, tri_setup_cuda
    from easyhec_torch.utils import profiling
    from easyhec_torch.utils.cuda_graph import _CondExec

    d0 = (xi + 0.01).cpu().numpy()
    gt = se3.exp(xi).cpu().numpy()
    torch.cuda.synchronize()
    _reset(kernels)
    _reset(_step_kernels())
    _CondExec.launches = bin_count_cuda.launches = 0
    tri_setup_cuda.launches = compact_pack_cuda.launches = 0
    t0 = time.perf_counter()
    res = calibrate(d0, renderer, lp, K, target, num_steps=steps, max_lr=3e-3,
                    rebin_every=0, Tc_c2b_gt=gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    call = [sp for sp in profiling.spans() if sp.name == "calib.call"][-1]
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[{label}] {steps} steps in {dt:.3f} s: {dt / steps * 1e3:.3f} ms/step, "
          f"{steps * B * H * W / dt:.0f} px/s fwd+bwd, {res.rebins} rebins; "
          f"{_CondExec.launches} launches of the step graph with its conditional rebin")
    if _CondExec.launches != steps:
        raise AssertionError(f"[{label}] {_CondExec.launches} step-graph launches for "
                             f"{steps} steps")
    print(f"[{label}] binner (bin_count) launches {bin_count_cuda.launches}, one per bin "
          f"build ({res.rebins})")
    if bin_count_cuda.launches != res.rebins:
        raise AssertionError(f"[{label}] {bin_count_cuda.launches} binner launches for "
                             f"{res.rebins} bin builds")
    launches["bin_count"] = bin_count_cuda.launches
    fused = renderer.tile.fused
    builds = {"tri_setup": tri_setup_cuda.launches, "compact_pack": compact_pack_cuda.launches}
    want = {"tri_setup": res.rebins if fused else 0,
            "compact_pack": res.rebins if fused and renderer.tile.compact_chunks > 0 else 0}
    print(f"[{label}] bin state launches {json.dumps(builds)}: the setup one per fused bin "
          f"build, the pack one per compact bin build ({res.rebins} bin builds)")
    if builds != want:
        raise AssertionError(f"[{label}] bin state launches {builds}, not {want}")
    launches.update(builds)
    launches.update(_check_step_kernels(label, steps, res.rebins, call.counts["kernel_steps"],
                                        fused))
    print(f"[{label}] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; launches "
          f"{json.dumps(launches)}; pose error {json.dumps(res.metrics)}")
    if res.overflow:
        raise AssertionError(f"bin overflow during calibrate ({label})")
    if not (np.isfinite(res.losses).all() and np.isfinite(res.dof).all()):
        raise AssertionError("non-finite loss or pose")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError("loss did not fall")
    fwd, bwd = [launches[k] for k in kernels]
    if fwd < steps or bwd != steps:
        raise AssertionError(f"launch counts {launches} for {steps} steps ({label})")
    return launches, dt / steps * 1e3, res.rebins


def _spread(xs) -> str:
    """median (min-max) of a list of ms/step."""
    import statistics

    return f"{statistics.median(xs):.3f} ({min(xs):.3f}-{max(xs):.3f})"


def _host_reads(fn) -> list[str]:
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") -> where it made
    each synchronizing CUDA operation (a host read of the device), as
    "file:line" of the Python line that made it."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in seen
            if str(w.message).startswith("called a synchronizing CUDA operation")]


@contextlib.contextmanager
def _capture_parts(parts: list):
    """The graph captures made inside the block, by part, from the program's
    own spans (easyhec_torch.utils.profiling): appends (part, seconds) to
    ``parts`` in the order the parts started, at the block's end.
    "warm_up" (utils.cuda_graph.warm_up), "capture" (a torch.cuda.graph
    block: its gc.collect and empty_cache, the captured Python, capture_end)
    and "instantiate" (utils.cuda_graph._CondExec: the conditional graph's
    assembly and cudaGraphInstantiate)."""
    from easyhec_torch.utils import profiling

    t0 = time.time_ns()
    try:
        yield parts
    finally:
        for s in sorted(profiling.spans(since_ns=t0), key=lambda s: s.id):
            if s.name.startswith("graph."):
                parts.append((s.name[len("graph."):], (s.end_ns - s.start_ns) / 1e9))


def main_eager_phase(lp, K, xi, steps, routes, reps=5):
    """The graphed calibrate against the eager runner on the same scene, in
    this call: per route, ``reps`` turns of (graphed, eager), each a
    ``steps``-step run of calib._calibrate_scan (calibrate's loop; under
    ``_graphs(False)`` it runs the same step function eagerly) from xi +
    0.01 with adaptive rebinning. Every graphed trace must equal the eager
    one bit for bit (losses, history, pose, rebins, overflow) and launch the
    route's kernels as often, the backward once per step. Prints ms/step
    median and spread per runner, the capture's seconds (warmup on copies,
    then the step graph with its conditional rebin) and, per turn, its
    parts (_capture_parts, from the program's spans: the warm-up, each
    capture with its gc.collect and empty_cache, the conditional graph's
    instantiation), each runner's peak device memory over what was
    allocated before the run, and the host reads per chunk of 50 of each
    runner (synchronizing operations under
    torch.cuda.set_sync_debug_mode("warn"), a 100-step run's less a 50-step
    run's, with the Python lines that made them): graphed, only _Scan.run's
    read after the chunk.
    routes: [(label, renderer, target, {name: wrapper})]."""
    import inspect
    import statistics
    from collections import Counter

    import torch

    from easyhec_torch.models import calib

    d0 = (xi + 0.01).detach()

    def run(r, target, n, graphed):
        with _graphs(graphed):
            return calib._calibrate_scan(d0, lp, K, target, r, n, 3e-3, "adam", "constant",
                                         0.0, 1.0, rebin_every=0)

    def per_chunk(r, target, graphed):  # a second chunk's reads: set-up cancels out
        two = Counter(_host_reads(lambda: run(r, target, 100, graphed)))
        return two - Counter(_host_reads(lambda: run(r, target, 50, graphed)))

    src, first = inspect.getsourcelines(calib._Scan.run)
    run_lines = {f"calib.py:{first + i}" for i in range(len(src))}
    reads = {label: {g: per_chunk(r, target, g) for g in (True, False)}
             for label, r, target, _ in routes}
    for label, r, target, kernels in routes:
        ms, peak, ref = {True: [], False: []}, {True: [], False: []}, None
        caps, cap_parts = [], []
        for _ in range(reps):
            for graphed in (True, False):
                _reset(kernels)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                parts = []
                t0 = time.perf_counter()
                with _capture_parts(parts) if graphed else contextlib.nullcontext():
                    out = run(r, target, steps, graphed)
                torch.cuda.synchronize()
                ms[graphed].append((time.perf_counter() - t0) / steps * 1e3)
                peak[graphed].append((torch.cuda.max_memory_allocated() - base) / 2**20)
                launches = {k: fn.launches for k, fn in kernels.items()}
                if graphed:
                    caps.append(sum(t for _, t in parts))
                    cap_parts.append(", ".join(f"{k} {v:.3f}" for k, v in parts))
                dof, losses, history, ov, rebins = out
                if ov or list(launches.values())[1] != steps:
                    raise AssertionError(f"[main eager] {label}: overflow {ov} or "
                                         f"launches {launches} for {steps} steps")
                if ref is None:
                    ref = (out, launches)
                    continue
                (d1, l1, h1, o1, r1), la = ref
                if not (torch.equal(losses, l1) and torch.equal(history, h1)
                        and torch.equal(dof, d1) and (ov, rebins) == (o1, r1)
                        and launches == la):
                    raise AssertionError(f"[main eager] {label}: graphed={graphed} "
                                         f"differs from the first run (rebins {rebins} "
                                         f"vs {r1}, launches {launches} vs {la})")
        if set(reads[label][True]) - run_lines or not reads[label][True]:
            raise AssertionError(f"[main eager] {label}: a graphed chunk reads the host "
                                 f"at {dict(reads[label][True])}, not only in _Scan.run")
        g, e = ms[True], ms[False]
        print(f"[main eager] {label}: {reps} turns of graphed then eager, {steps} steps "
              f"each; ms/step graphed {_spread(g)}, eager {_spread(e)}: eager / graphed "
              f"{statistics.median(e) / statistics.median(g):.2f}x; traces bit-identical "
              f"across all {2 * reps} runs ({ref[0][4]} rebins, launches "
              f"{json.dumps(ref[1])}); capture (warmup + the step graph) "
              f"{', '.join(f'{c:.3f}' for c in caps)} s; peak memory over the scene "
              f"graphed {max(peak[True]):.1f} MiB, eager {max(peak[False]):.1f} MiB "
              f"({GPU})")
        print(f"[main eager] {label}: each graphed turn's capture by part, s: "
              + "; ".join(f"turn {i}: {c}" for i, c in enumerate(cap_parts)))
        print(f"[main eager] {label}: host reads per chunk of 50 (synchronizing "
              f"operations under set_sync_debug_mode, 100 steps less 50): graphed "
              f"{sum(reads[label][True].values())} at {dict(reads[label][True])} (the "
              f"chunk's read of the overflow flag and the rebin count), eager "
              f"{sum(reads[label][False].values())} at {dict(reads[label][False])}")


FD_EPS = 1e-4  # central-difference step of [behaviour] (tests/test_fused.py:184)
CAPTURE_MAGS = (0.05, 0.1, 0.15, 0.3)  # [behaviour]'s se(3) perturbation norms


def behaviour_phase(routes, lp, K, xi, steps):
    """[behaviour]: the end results of the JAX package's slow tests, on the
    card at the bench scene.

    1. Each route's analytic pose gradient (routes: (label, renderer, target,
       forward wrapper, backward wrapper): compact K2f/K2b, dense K1f/K1b,
       unfused K5f and the counted K5b) against central differences of its
       own forward (``calib.mask_loss``, the calibration's loss, its bin
       state built at each pose) at the bench start pose xi + 0.01, with
       tests/test_fused.py:173-188's rule: each component within max(12 %
       of the FD component, 3 % of max|g|) at eps FD_EPS (the step taken
       is the f32 difference of the two poses). Printed first: the spread
       of 5 repeated forwards (0 under the fixed-order sums) and the FD at
       eps 1e-4 and 1e-3; the launches (one backward per gradient).
    2. The capture profile: ``calibrate`` on the compact route, ``steps``
       Adam steps at 3e-3 with adaptive rebinning, from xi + m·d for m in
       CAPTURE_MAGS, d a unit se(3) direction from numpy's default_rng(7)
       (tests/test_capture_range.py:92-94); converged within 1 cm
       (err_trans) and 1 deg (err_rot). Asserts what JAX's profile test
       asserts: 0.05 converges, and if 0.3 converges so does 0.15.
    Prints the phase's seconds."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate, mask_loss

    t_phase = time.perf_counter()
    x0 = (xi + 0.01).float()
    for label, r, target, fwd, bwd in routes:
        kern = {"fwd": fwd, "bwd": bwd}

        def loss(x):
            with torch.no_grad():
                return float(mask_loss(x, r, lp, K, target))

        _reset(kern)
        x = x0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(mask_loss(x, r, lp, K, target), x)
        g = g.cpu().numpy().astype(np.float64)
        grad_launches = {k: fn.launches for k, fn in kern.items()}
        reps = [loss(x0) for _ in range(5)]
        fd = {}
        for eps in (1e-4, 1e-3):
            fd[eps] = np.zeros(6)
            for i in range(6):
                e = torch.zeros(6, device=x0.device)
                e[i] = eps
                xp, xm = x0 + e, x0 - e
                step = float(xp[i]) - float(xm[i])  # the f32 step actually taken
                fd[eps][i] = (loss(xp) - loss(xm)) / step
        gmax = np.abs(g).max()
        tol = np.maximum(0.12 * np.abs(fd[FD_EPS]), 0.03 * gmax)
        err = np.abs(g - fd[FD_EPS])
        print(f"[behaviour] FD {label}: loss {reps[0]:.6f}, spread of 5 repeated forwards "
              f"{max(reps) - min(reps):.3e}; analytic g {np.array2string(g, precision=4)}; FD at "
              f"eps 1e-4 {np.array2string(fd[1e-4], precision=4)}; at 1e-3 "
              f"{np.array2string(fd[1e-3], precision=4)}; |g - FD(eps {FD_EPS:g})| / tol "
              f"{np.array2string(err / tol, precision=3)} (tol max(12 % |FD|, 3 % max|g| = "
              f"{0.03 * gmax:.4f})); launches for the gradient {json.dumps(grad_launches)}, "
              f"{kern['fwd'].launches - grad_launches['fwd']} forwards for the differences")
        if grad_launches["bwd"] != 1 or grad_launches["fwd"] < 1:
            raise AssertionError(f"[behaviour] {label}: the gradient launched {grad_launches}")
        if not (np.isfinite(g).all() and gmax > 0 and (err < tol).all()):
            raise AssertionError(f"[behaviour] {label}: the analytic gradient {g} disagrees with "
                                 f"central differences {fd[FD_EPS]} (tol {tol})")

    label, r, target = routes[0][:3]
    d = np.random.default_rng(7).normal(size=6)
    d = d / np.linalg.norm(d)
    gt = se3.exp(xi).cpu().numpy()
    results = {}
    for mag in CAPTURE_MAGS:
        t0 = time.perf_counter()
        res = calibrate((xi.cpu().numpy() + mag * d).astype(np.float32), r, lp, K, target,
                        num_steps=steps, max_lr=3e-3, rebin_every=0, Tc_c2b_gt=gt,
                        on_overflow="warn")
        m = res.metrics
        ok = bool(m["err_trans"] < 1.0 and m["err_rot"] < 1.0)
        results[mag] = ok
        print(f"[behaviour] capture {label} from xi_gt + {mag}·d: {steps} steps in "
              f"{time.perf_counter() - t0:.3f} s, loss {res.losses[0]:.3f} -> "
              f"{res.losses[-1]:.3f}, {res.rebins} rebins, overflow {res.overflow}; error "
              f"{m['err_trans']:.4f} cm {m['err_rot']:.4f} deg (geodesic "
              f"{m['err_trans_geodesic_cm']:.4f} cm {m['err_rot_geodesic_deg']:.4f} deg): "
              f"{'converged' if ok else 'not converged'}")
        if not (np.isfinite(res.losses).all() and np.isfinite(res.dof).all()):
            raise AssertionError(f"[behaviour] capture from {mag}: non-finite loss or pose")
    print(f"[behaviour] capture profile (converged within 1 cm and 1 deg) "
          f"{json.dumps({str(k): v for k, v in results.items()})} along d = "
          f"{np.array2string(d, precision=4)}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s; {GPU}")
    if not results[0.05] or (results[0.3] and not results[0.15]):
        raise AssertionError(f"[behaviour] capture profile {results}: 0.05 must converge and "
                             f"the basin must not be inverted")


def trainer_phase(lp, K, xi, qs, target, steps, out_dir):
    """run_offline_calibration on the dense route at the bench scene, with an
    in-memory Config and CalibBatch (the bench scene has no config file;
    [cli] runs the CLIs from configs/), writing its run under ``out_dir``.
    Returns (launches, ms/step, the Config, the batch)."""
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
            "checkpoints/final.npz", "metrics.jsonl", "error_maps.png"]
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


@contextlib.contextmanager
def _patched(holder, name, value):
    """holder.name = value inside the block."""
    real = getattr(holder, name)
    setattr(holder, name, value)
    try:
        yield real
    finally:
        setattr(holder, name, real)


def _graphs(graphed: bool):
    """utils.cuda_graph.captures, the one place that says whether work on
    the card runs as CUDA graphs, as it is (graphed) or refusing (eager),
    inside the block."""
    from easyhec_torch.utils import cuda_graph

    if graphed:
        return contextlib.nullcontext()
    return _patched(cuda_graph, "captures", lambda device: False)


SEARCH_STAGES = ("_sweep", "_moment_refine", "_grad_refine")
STAGE_SPANS = ("search.sweep", "search.moment_refine", "search.grad_refine")


@contextlib.contextmanager
def _search_stages(secs: dict, spans: dict):
    """Inside the block, the host seconds of each stage of global_search_init
    from the program's spans (STAGE_SPANS: the stage's capture and the
    queueing of its replays), added to secs[stage], and each CUDA graph
    replay between two CUDA events, appended to spans[stage] for the stage
    span it was queued in: the card's time for the stage's replays, queued
    back to back."""
    import torch

    from easyhec_torch.utils import cuda_graph, profiling

    t0, queued = time.time_ns(), []
    real_replay = cuda_graph.Graph.replay

    def replay(self):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        at = time.time_ns()
        e0.record()
        real_replay(self)
        e1.record()
        queued.append((at, e0, e1))

    with _patched(cuda_graph.Graph, "replay", replay):
        yield
    stages = [s for s in profiling.spans(since_ns=t0) if s.name in STAGE_SPANS]
    for s in stages:
        secs[s.name] = secs.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    for at, e0, e1 in queued:
        name = next((s.name for s in stages if s.start_ns <= at <= s.end_ns), "other")
        spans.setdefault(name, []).append((e0, e1))


def _by_stage(parts) -> list[float]:
    """_capture_parts' (part, seconds) list of one search -> the seconds of
    each stage's capture (its warm-up and its capture), the parts up to and
    including each "capture"."""
    out, acc = [], 0.0
    for part, t in parts:
        acc += t
        if part == "capture":
            out.append(acc)
            acc = 0.0
    return out


def search_phase(renderer, lp, K, xi, target, reps=3):
    """global_search_init at its defaults on frame 0 (3072 candidates scored
    at 1/8 resolution in batches of 64, moments, 200 Adam steps on the top
    16): one K5f per batch, per moment iteration and per step, plus the
    final IoU; one K5b per step. ``reps`` turns of graphed (the sweep's
    batch, the moment refine and the Adam step each one CUDA graph) then
    eager (_graphs): every run's scores,
    tiles at cap, pose, score and launches equal the first's bit for bit.
    Prints the seconds (median and spread), each graphed turn's capture
    seconds by stage (_capture_parts), each runner's peak memory over what
    was allocated before, then one more run of each with its host seconds
    by stage (_search_stages: the search.* spans) and, graphed, the device
    span of each stage's replays by CUDA events, and the host reads of a
    graphed run (set_sync_debug_mode, by line). Returns the result."""
    import inspect
    import statistics
    from collections import Counter

    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models import pose_init
    from easyhec_torch.models.calib import pose_metrics
    from easyhec_torch.models.pose_init import global_search_init
    from easyhec_torch.ops import tile_raster as tr

    kernels = {"tile_fwd": tr.tile_fwd_cuda, "tile_bwd_counted": tr.tile_bwd_counted_cuda,
               "tile_bwd": tr.tile_bwd_cuda}
    want = {"tile_fwd": 48 + 2 + 200 + 1, "tile_bwd_counted": 200, "tile_bwd": 0}
    args = (renderer, lp[0].cpu().numpy(), K.cpu().numpy(), target[0].cpu().numpy())

    def run(graphed):
        with _graphs(graphed):
            return global_search_init(*args)

    def same(a, b):
        return (np.array_equal(a.scores, b.scores) and np.array_equal(a.Tc_c2b, b.Tc_c2b)
                and a.score == b.score and a.tiles_at_cap == b.tiles_at_cap)

    secs, peak, caps, ref = {True: [], False: []}, {True: [], False: []}, [], None
    for _ in range(reps):
        for graphed in (True, False):
            torch.cuda.synchronize()
            _reset(kernels)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            parts = []
            t0 = time.perf_counter()
            with _capture_parts(parts) if graphed else contextlib.nullcontext():
                res = run(graphed)
            torch.cuda.synchronize()
            secs[graphed].append(time.perf_counter() - t0)
            peak[graphed].append((torch.cuda.max_memory_allocated() - base) / 2**20)
            launches = {k: fn.launches for k, fn in kernels.items()}
            if graphed:
                caps.append(_by_stage(parts))
            if launches != want:
                raise AssertionError(f"K5 launches {launches} in the global search "
                                     f"(graphed={graphed})")
            if ref is None:
                ref = res
            elif not same(res, ref):
                raise AssertionError(f"[search eager] graphed={graphed} differs from the first "
                                     f"run: score {res.score} vs {ref.score}, tiles at cap "
                                     f"{res.tiles_at_cap} vs {ref.tiles_at_cap}")
    res = ref
    gt = se3.exp(xi).cpu().numpy()
    err = pose_metrics(se3.log(torch.from_numpy(res.Tc_c2b)).numpy(), gt)

    def center(T):  # camera center in the base frame, unit
        c = -T[:3, :3].T @ T[:3, 3]
        return c / np.linalg.norm(c)

    cos = float(center(res.Tc_c2b) @ center(gt))
    g, e = secs[True], secs[False]
    print(f"[search] global_search_init at its defaults on frame 0, graphed: "
          f"{statistics.median(g):.3f} s (median of {reps}), {res.scores.size} candidates, best "
          f"IoU {res.score:.4f} (best sweep score {res.scores.max():.4f}); launches "
          f"{json.dumps(want)}; share of scoring tiles at cap {res.tiles_at_cap:.4f}; view "
          f"direction cos to GT {cos:.4f} (the JAX package's own search test asks > 0.5); "
          f"pose error {json.dumps(err)}")
    if not (np.isfinite(res.Tc_c2b).all() and 0 < res.score <= 1):
        raise AssertionError("global search gave no finite pose")
    print(f"[search eager] {reps} turns of graphed then eager: s graphed {_spread(g)}, eager "
          f"{_spread(e)}: eager / graphed {statistics.median(e) / statistics.median(g):.2f}x; "
          f"scores, tiles at cap, pose and launches bit-identical across all {2 * reps} runs; "
          f"capture (warm-up + graph) by stage, s (sweep, moments, refine): "
          + "; ".join(", ".join(f"{c:.3f}" for c in turn) for turn in caps)
          + f"; peak memory over the scene graphed {max(peak[True]):.1f} MiB, eager "
          f"{max(peak[False]):.1f} MiB ({GPU})")
    for graphed in (True, False):
        stage_s, spans = {}, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _search_stages(stage_s, spans):
            same_res = run(graphed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not same(same_res, ref):
            raise AssertionError(f"[search eager] the staged run (graphed={graphed}) differs")
        dev_ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
        print(f"[search eager] one {'graphed' if graphed else 'eager'} run: {dt:.3f} s; "
              f"host s by stage (the search.* spans) "
              + ", ".join(f"{k.removeprefix('search.')} {v:.3f}" for k, v in stage_s.items())
              + f", the rest {dt - sum(stage_s.values()):.3f}"
              + ("; device span of the stage's graph replays, ms: "
                 + ", ".join(f"{k.removeprefix('search.')} {v:.3f} ({len(spans[k])} replays)"
                             for k, v in dev_ms.items()) if graphed else ""))
    reads = Counter(_host_reads(lambda: run(True)))
    stages = set()
    for name in SEARCH_STAGES:
        src, first = inspect.getsourcelines(getattr(pose_init, name))
        stages |= {f"pose_init.py:{first + i}" for i in range(len(src))}
    print(f"[search eager] host reads of a graphed run (synchronizing operations under "
          f"set_sync_debug_mode): {sum(reads.values())} at {dict(reads)}")
    if any(not r.startswith("pose_init.py:") or r in stages for r in reads):
        raise AssertionError("[search eager] the graphed search reads the host inside a stage "
                             "or below global_search_init")
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
    search (251 K5f, 200 K5b), then calibrate (K2f/K2b); with the search
    graphed, then eager (_graphs): the
    losses and pose bit for bit, the seconds of each."""
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
    out = {}
    for graphed in (True, False):
        with tempfile.TemporaryDirectory() as tmp, _graphs(graphed):
            cfg.output_dir = tmp
            torch.cuda.synchronize()
            _reset(kernels)
            t0 = time.perf_counter()
            res = offline.run_offline_calibration(cfg, batch=batch, device=DEVICE)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in kernels.items()}
            run_dir = Path(tmp)
            want = ["Tc_c2b.txt", "metrics.json", "eval.json", "config.yaml",
                    "checkpoints/final.npz", "metrics.jsonl"]
            missing = [f for f in want if not (run_dir / f).is_file()]
            wall = json.loads((run_dir / "checkpoints" / "final.json").read_text())["wall_time_s"]
        out[graphed] = res
        print(f"[trainer search] run_offline_calibration, compact route, init_method="
              f"global_search, the search {'graphed' if graphed else 'eager'}: {dt:.3f} s in "
              f"all, calibrate {wall:.3f} s for {steps} steps; loss {res.losses[0]:.3f} -> "
              f"{res.losses[-1]:.3f}; {res.rebins} rebins; launches {json.dumps(launches)}; "
              f"pose error {json.dumps(res.metrics)}")
        if missing:
            raise AssertionError(f"trainer artifacts missing: {missing}")
        if not (np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]):
            raise AssertionError("trainer loss did not fall")
        # K5f: the pre-check's one launch and the search's 251; K5b: the search's
        if launches["tile_fwd"] != 1 + 251 or launches["tile_bwd_counted"] != 200:
            raise AssertionError(f"K5 launches {launches} in the global-search trainer run")
        if launches["loss_bwd_compact"] < steps:
            raise AssertionError(f"K2 launches {launches} for {steps} steps")
    if not (np.array_equal(out[True].losses, out[False].losses)
            and np.array_equal(out[True].dof, out[False].dof)):
        raise AssertionError("[trainer search] the graphed and eager searches lead to "
                             "different calibrations")
    return launches


def _all_kernels():
    """Every rasterizer kernel wrapper's launch counter (ops.pose_raster.COUNTED
    but the bin state's: the binner, which every bin state of every route on
    the card launches, and the triangle setup and compact pack around it;
    main_path and iterative_phase count those against the bin states they
    build), by its name without ``_cuda``."""
    from easyhec_torch.ops import binning, rebin
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact, tile_raster  # noqa: F401

    skip = (binning.bin_count_cuda, rebin.tri_setup_cuda, rebin.compact_pack_cuda,
            *_step_kernels().values())
    return {fn.__name__.removesuffix("_cuda"): fn for fn in pr.COUNTED if fn not in skip}


def _step_kernels():
    """The kernel route's step kernels (ops/step.py), which every step of a
    fused calibration launches: main_path and parallel_nccl_phase count them."""
    from easyhec_torch.ops import step

    return {"step_head": step.step_head_cuda, "step_grad": step.step_grad_cuda,
            "step_update": step.step_update_cuda}


def _check_step_kernels(label, steps, rebins, kernel_steps, fused):
    """The step kernels' launches since their reset and the call's
    kernel_steps: on a fused route one grad and one update a step and one
    head a step and a rebin (the rebin takes its pose from the head), and
    kernel_steps the steps; else none. -> the launches by name."""
    got = {k: fn.launches for k, fn in _step_kernels().items()}
    want = ({"step_head": steps + rebins, "step_grad": steps, "step_update": steps} if fused
            else dict.fromkeys(got, 0))
    print(f"[{label}] step kernel launches {json.dumps(got)}, kernel_steps {kernel_steps} "
          f"({steps} steps, {rebins} rebins)")
    if got != want or kernel_steps != (steps if fused else 0):
        raise AssertionError(f"[{label}] step kernels {got} and kernel_steps {kernel_steps}, "
                             f"not {want} and {steps if fused else 0}")
    return got


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


OPT_GROUPS = {  # make_optimizer's options beyond the calibration's, alone and together
    "grad_clip_value": dict(grad_clip_value=2e-3),
    "weight_decay": dict(weight_decay=0.1),
    "bias_lr_factor": dict(bias_lr_factor=2.0),
    "weight_decay_bias": dict(weight_decay_bias=0.05),
    "all": dict(grad_clip=0.05, grad_clip_value=2e-3, weight_decay=0.1, bias_lr_factor=2.0,
                weight_decay_bias=0.05),
    "sgd all": dict(name="sgd", grad_clip=0.05, grad_clip_value=2e-3, weight_decay=0.1,
                    bias_lr_factor=2.0, weight_decay_bias=0.05),
}


def _tree_map(f, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def optimizer_groups_phase(steps=20):
    """make_optimizer over the U-Net's parameter dict (base 16, 118,913
    parameters in the flax-layout tree: 21 conv and GroupNorm "bias" leaves
    form the bias group) under each option beyond the calibration's, adam
    and sgd, warmup_cosine over ``steps`` steps, on the card and on the CPU
    from the same params and gradients (the BCE gradient at the initial
    params on two 64x64 images, plus seeded noise of each leaf's scale, one
    draw per step). The card's final params and state leaves are held to
    the CPU's at rtol 1e-6 with a floor of one ulp of the leaf's largest
    entry per step (steps·eps·max|leaf|): the ops are the same elementwise
    ops, the global norm sums in another order."""
    import numpy as np
    import torch

    from easyhec_torch.convert import unet_state_to_flax
    from easyhec_torch.models.segmentation import UNet, _bce_loss, _flax_init
    from easyhec_torch.solver.optim import _flatten, make_optimizer

    model = UNet(16)
    _flax_init(model, torch.Generator().manual_seed(0))
    names, params = zip(*model.named_parameters())
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((2, 64, 64, 3), generator=gen)
    y = (torch.rand((2, 64, 64), generator=gen) > 0.5).float()
    g0 = torch.autograd.grad(_bce_loss(model(x), y), params)
    p0 = unet_state_to_flax(dict(zip(names, (p.detach() for p in params))))
    g0 = unet_state_to_flax(dict(zip(names, g0)))
    leaves, labels = _flatten(p0)  # the leaves in optax's order, each with its group
    n_par = sum(a.size for a in leaves)
    n_bias = labels.count("bias")
    noise = torch.Generator().manual_seed(2)
    grads = [_tree_map(lambda g: g + g.std() * torch.randn(g.shape, generator=noise).numpy(),
                       g0) for _ in range(steps)]
    eps = float(np.finfo(np.float32).eps)
    worst = 0.0
    for label, kw in OPT_GROUPS.items():
        kw = dict(kw)
        name = kw.pop("name", "adam")
        opt = make_optimizer(name, max_lr=1e-3, total_steps=steps, scheduler="warmup_cosine",
                             warmup_steps=5, **kw)
        out = {}
        for dev in (DEVICE, "cpu"):
            p = _tree_map(lambda a: torch.tensor(a, device=dev), p0)
            gs = [_tree_map(lambda a: torch.tensor(a, device=dev), g) for g in grads]
            st = opt.init(p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for g in gs:
                u, st = opt.update(g, st, p)
                p = _tree_map(lambda a, b: a + b, p, u)
            torch.cuda.synchronize()
            out[dev] = (time.perf_counter() - t0, _flatten(p)[0], opt.leaves(st))
        (dt, pk, sk), (_, pc, sc) = out[DEVICE], out["cpu"]
        err = rel = 0.0
        for a, b in zip(pk + sk, pc + sc):
            a, b = a.cpu(), b.cpu()
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"[optimizer groups] {label}: leaf {a.dtype} "
                                     f"{tuple(a.shape)} against {b.dtype} {tuple(b.shape)}")
            if b.dtype == torch.int32:
                if not torch.equal(a, b):
                    raise AssertionError(f"[optimizer groups] {label}: counts differ")
                continue
            d = (a - b).abs()
            err = max(err, float(d.max()))
            floor = steps * eps * float(b.abs().max())
            rel = max(rel, float((d / (1e-6 * b.abs() + floor)).max()) if floor else 0.0)
            torch.testing.assert_close(a, b, rtol=1e-6, atol=floor)
        worst = max(worst, err)
        print(f"[optimizer groups] {label} ({name}, {json.dumps(kw)}): {steps} steps over "
              f"{len(pk)} leaves, {len(sk)} state leaves: card {dt / steps * 1e3:.3f} ms/step "
              f"(host-timed, {GPU}); card vs CPU max abs err {err:.3e}, {rel:.3f} of the "
              f"tolerance")
    print(f"[optimizer groups] U-Net base 16: {n_par} params in {len(leaves)} leaves, "
          f"{n_bias} of them bias; worst card-vs-CPU error {worst:.3e}")
    if n_par != 118913 or n_bias != 21:
        raise AssertionError(f"U-Net tree: {n_par} params, {n_bias} bias leaves")


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


def lr_finder_phase(renderer, lp, K, xi, target, steps=100, reps=3):
    """find_lr (Adam, 100 steps from 1e-6 to 1) over the compact calibration
    loss at the bench scene on one bin state built at the start pose: one
    K2f and one K2b launch per step and a finite suggestion. ``reps`` turns
    of graphed (one step graph replayed per step) then eager
    (_graphs): the losses bit for bit,
    ms/step median and spread of each."""
    import statistics

    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import mask_loss, tile_masks
    from easyhec_torch.solver import lr_finder

    d0 = (xi + 0.01).detach()
    st = renderer.bin_state(se3.exp(d0), lp, K)
    ref = tile_masks(target, renderer)
    kernels = _all_kernels()
    ms, first = {True: [], False: []}, None
    for _ in range(reps):
        for graphed in (True, False):
            with _graphs(graphed):
                torch.cuda.synchronize()
                _reset(kernels)
                t0 = time.perf_counter()
                res = lr_finder.find_lr(
                    lambda d: mask_loss(d, renderer, lp, K, target, bin_state=st,
                                        ref_tiles=ref), d0, num_steps=steps)
                ms[graphed].append((time.perf_counter() - t0) / steps * 1e3)
            launches = _launched(kernels)
            if not np.isfinite(res.suggestion) or launches != {"loss_fwd_compact": steps,
                                                              "loss_bwd_compact": steps}:
                raise AssertionError(f"lr_finder: suggestion {res.suggestion}, launches "
                                     f"{launches}")
            if first is None:
                first = res
            elif not np.array_equal(res.losses, first.losses):
                raise AssertionError(f"[lr_finder] graphed={graphed} losses differ from the "
                                     "first run's")
    g, e = ms[True], ms[False]
    print(f"[lr_finder] {steps} Adam steps, {reps} turns of graphed then eager: ms/step "
          f"graphed {_spread(g)}, eager {_spread(e)} (eager / graphed "
          f"{statistics.median(e) / statistics.median(g):.2f}x), losses bit-identical across "
          f"all {2 * reps} runs: suggestion {first.suggestion:.4e}, diverged at "
          f"{first.diverged_at}, loss {first.losses[0]:.3f} -> min "
          f"{np.nanmin(first.losses):.3f}; launches {json.dumps(launches)} ({GPU})")


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


def watch_phase(run_dir, steps, log_interval):
    """utils.live.serve (cli/watch's server) in the background on the
    trainer's run dir, on a free local port: /api/ls lists images/, which
    holds the trainer's mid-run panels (an error_map and a rendered PNG
    every log_interval steps, written without matplotlib), error_maps.png
    is beside it, and live.html is served."""
    import socket
    import urllib.request

    import numpy as np

    from easyhec_torch.utils.imaging import read_png
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
    run_dir = Path(run_dir)
    want = sorted(p.name for p in (run_dir / "images").glob("*.png"))
    panels = sorted(f"{tag}_{s:06d}.png" for s in range(log_interval, steps + 1, log_interval)
                    for tag in ("error_map", "rendered"))
    shapes = {tuple(read_png(run_dir / "images" / n).shape) for n in panels if n in want}
    colors = len(np.unique(read_png(run_dir / "images" / panels[-1]).reshape(-1, 3), axis=0)) \
        if panels[-1] in want else 0
    grid = read_png(run_dir / "error_maps.png").shape if (run_dir / "error_maps.png").is_file() \
        else None
    print(f"[watch] /api/ls on the trainer run dir: {len(ls)} images ({len(panels)} mid-run "
          f"panels expected, every {log_interval} steps: shapes {sorted(shapes)}, "
          f"{colors} colors in {panels[-1]}); error_maps.png {grid}; {DASHBOARD_NAME} "
          f"{len(page)} bytes")
    if not ls or ls != want or b"easyhec_torch live" not in page:
        raise AssertionError("watch: /api/ls or the dashboard is wrong")
    if not set(panels) <= set(want) or shapes != {(H, W, 3)} or colors < 2:
        raise AssertionError(f"watch: the trainer's mid-run panels are missing or wrong: "
                             f"{sorted(set(panels) - set(want))}")
    if grid is None or grid[2] != 3:
        raise AssertionError("watch: error_maps.png is missing")


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


def _device_us(prof) -> tuple[float, int]:
    """(device microseconds, device ops) of a torch.profiler trace."""
    from torch.autograd import DeviceType

    evs = [ev for ev in prof.events() if ev.device_type != DeviceType.CPU
           and not getattr(ev, "is_user_annotation", False)]
    return sum(ev.device_time_total for ev in evs), len(evs)


def _profile(renderer, lp, K, d0, target, steps, main_rebins, out, tag, fwd_pat, bwd_pat,
             body_reps=20):
    """Replay a ``calibrate`` run (same start, steps and settings, so the
    same rebin rate) under torch.profiler: calibrate's loop over chunks of
    50 on the scan it sets up (calib._chunk_scan), captured as a CUDA graph
    (the step, its rebin a conditional node) before the profiler starts, so
    the trace holds the replays. Reports that run's own device busy share
    (device time over its wall time) and its device time per step by part.
    A rebin runs inside the step graph, unmarked, so its device time is read
    apart: the conditional body (the scan's ``_rebin``) captured alone on a
    copy of the scan and replayed ``body_reps`` times under a second
    profile; the rebin part of a step is that time per replay times the
    run's rebins over its steps. Before it, unprofiled, the same run on a
    scan of its own: the host's seconds to enqueue each chunk's graph
    launches against the card's to finish them. Writes
    out/profile_<tag>.txt (top ops) and
    out/profile_breakdown_<tag>.json. No chrome trace: at 1000 steps it
    would hold millions of events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from easyhec_torch.models import calib
    from easyhec_torch.utils.cuda_graph import Counters, Graph

    out.mkdir(parents=True, exist_ok=True)
    opt = calib.make_optimizer("adam", max_lr=3e-3, total_steps=steps)
    d = torch.as_tensor(d0, dtype=torch.float32, device=DEVICE)

    def new_scan():  # calibrate's scan from d0, captured here
        return calib._chunk_scan(d, opt.init(d), opt, lp, K, target,
                                 calib.tile_masks(target, renderer), renderer,
                                 min(50, steps), 1.0, 0.0, 0)

    scan = new_scan()
    enqueue_s = wall_s = 0.0  # unprofiled: the host's share of a chunk's time
    for done in range(0, steps, 50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan.queue(min(50, steps - done))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue_s, wall_s = enqueue_s + t1 - t0, wall_s + time.perf_counter() - t0
    print(f"[profile {tag}] unprofiled chunks of 50: the host enqueues a step's graph "
          f"launch in {enqueue_s / steps * 1e3:.4f} ms, the card finishes a step in "
          f"{wall_s / steps * 1e3:.4f} ms ({GPU})")
    scan = new_scan()  # the profiled run starts from d0 too: the same rebins
    rebins = 0
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for done in range(0, steps, 50):
            rebins += scan.run(min(50, steps - done))[5]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    body = scan._on(dict(scan.bufs))  # its _rebin rebinds body's state, not the scan's
    body_graph = Graph(body._rebin, Counters.kernels())
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_body:
        for _ in range(body_reps):
            body_graph.replay()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    us = dict(total=0.0, fwd=0.0, bwd=0.0)
    n_ops = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU or getattr(ev, "is_user_annotation", False):
            continue
        us["total"] += ev.device_time_total
        n_ops += 1
        if fwd_pat in ev.name:
            us["fwd"] += ev.device_time_total
        elif bwd_pat in ev.name:
            us["bwd"] += ev.device_time_total
    body_us, body_ops = _device_us(prof_body)
    us["rebin"] = body_us / body_reps * rebins
    us["other"] = us["total"] - us["fwd"] - us["bwd"] - us["rebin"]
    per_step = {k: v / 1e3 / steps for k, v in us.items()}
    busy = us["total"] / 1e3 / wall_ms
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out / f"profile_{tag}.txt").write_text(table)
    summary = dict(route=tag, steps=steps, rebins=rebins, main_path_rebins=main_rebins,
                   wall_ms=wall_ms, device_ms=us["total"] / 1e3, busy_share=busy,
                   device_ops_per_step=n_ops / steps, device_ms_per_step=per_step,
                   device_ms_per_rebin=body_us / 1e3 / body_reps,
                   device_ops_per_rebin=body_ops / body_reps,
                   rebin_reader=f"the conditional body captured alone, {body_reps} replays",
                   enqueue_ms_per_step=enqueue_s / steps * 1e3,
                   unprofiled_ms_per_step=wall_s / steps * 1e3)
    (out / f"profile_breakdown_{tag}.json").write_text(json.dumps(summary, indent=1))
    print(f"[profile {tag}] graphed replay under torch.profiler: {steps} steps, "
          f"{rebins} rebins (unprofiled run {main_rebins}), {wall_ms:.3f} ms wall, "
          f"that is {wall_ms / steps:.3f} ms/step with the profiler on")
    print(f"[profile {tag}] device busy {us['total'] / 1e3:.3f} ms of that run's "
          f"{wall_ms:.3f} ms wall = {busy:.4f}; {n_ops / steps:.1f} device ops per step")
    print(f"[profile {tag}] device ms per step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_step.items())
        + f" (fwd = {fwd_pat}, bwd = {bwd_pat}); {summary['device_ms_per_rebin']:.4f} "
        f"ms and {body_ops / body_reps:.1f} device ops per rebin (the conditional body "
        f"captured alone, {body_reps} replays); post-processing "
        f"{time.perf_counter() - t0:.1f} s")


# The online loop at configs/xarm7_example.yaml's widths (the xArm7 assets
# are not in the repo: the mini arm at 8 mm edges stands in for it).
ITER_H, ITER_W, ITER_F = 720, 1280, 906.8


def iterative_config(steps, H=ITER_H, W=ITER_W, rounds=5, n_sample=1000, n_hyp=10,
                     history_start=200):
    """An in-memory Config with xarm7_example's render, solver and explorer
    settings, on the mini arm at 8 mm edges ([cli] runs the file itself)."""
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
    scoring pass and the binner's to one per bin state. Returns (launches,
    the round-1 explore call's inputs)."""
    import math
    import tempfile

    import numpy as np
    import torch

    from easyhec_torch.cli.run import perturbed_start
    from easyhec_torch.io.interfaces import SimCamera
    from easyhec_torch.models.explorer import SpaceExplorer
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops.binning import bin_count_cuda
    from easyhec_torch.ops.rebin import compact_pack_cuda, tri_setup_cuda
    from easyhec_torch.trainer import iterative as itr

    cfg = iterative_config(steps)
    gt, K = iterative_rig()
    cfg.model.init_Tc_c2b = perturbed_start(gt, cfg.solver.seed)
    counters = {"K2f/K3": prc.loss_fwd_compact_cuda, "K2b": prc.loss_bwd_compact_cuda,
                "K4f": pr.sil_fwd_cuda, "bin": bin_count_cuda, "setup": tri_setup_cuda,
                "pack": compact_pack_cuda}
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
        rounds[-1].update(explore_s=dt, K3=d["K2f/K3"], bins=d["bin"], setups=d["setup"],
                          packs=d["pack"], explore=res,
                          shared=self.last_shared,
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
                f"{r['explore_s']:.3f} (graphed), plan {r['plan_s']:.3f}; launches K2f {r['K2f']} "
                f"K2b {r['K2b']} K3 {r['K3']} K4f {r['K4f']}")
        if "explore" in r:
            e = r["explore"]
            line += (f"; explorer: variance {e.variance:.3f}, {int(e.feasible.sum())}/"
                     f"{len(e.feasible)} feasible, {'shared' if r['shared'] else 'exact'} "
                     f"(spread {r['spread']:.2f} px), {r['esc']} escalations, max tile load "
                     f"{r['max_load']} (cap {r['cap']}), {r['bin_states']} bin states, "
                     f"{r['bins']} binner, {r['setups']} setup and {r['packs']} pack "
                     f"launches and {r['K3']} K3 launches "
                     f"({r['K3'] / (1 + r['esc']):.0f} per _score)")
            if r["K3"] != (1 + r["esc"]) * per_score:
                raise AssertionError(f"round {i}: {r['K3']} K3 launches for {1 + r['esc']} "
                                     f"scoring passes of {per_score}")
            if r["bin_states"] != per_score // (Hh if r["shared"] else 1):
                raise AssertionError(f"round {i}: {r['bin_states']} bin states per _score")
            if r["bins"] < r["bin_states"] or (not r["esc"] and r["bins"] != r["bin_states"]):
                raise AssertionError(f"round {i}: {r['bins']} binner launches for "
                                     f"{r['bin_states']} bin states per _score")
            if not r["setups"] == r["packs"] == r["bins"]:
                raise AssertionError(f"round {i}: {r['setups']} setup and {r['packs']} pack "
                                     f"launches for {r['bins']} bin builds")
        line += f"; planned {r.get('planned')}"
        print(line)
    m = res.metrics
    launches = {"K2f": sum(r["K2f"] for r in rounds), "K2b": totals["K2b"],
                "K3": sum(r["K3"] for r in rounds), "K4f": totals["K4f"],
                "bin_count explore": sum(r.get("bins", 0) for r in rounds),
                "tri_setup explore": sum(r.get("setups", 0) for r in rounds),
                "compact_pack explore": sum(r.get("packs", 0) for r in rounds)}
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
    # The scoring pass of round 1's draw on its first 200 candidates (40
    # batches), graphed (one graph captured per call, replayed per batch)
    # then eager: bit for bit, and the seconds.
    hyp, qs = hist[sel], qs[:200]
    shared = e._can_share_bins() and \
        e.hypothesis_spread_px(hyp, explore_in["K"]) <= float(t.margin) - 2.0
    secs, outs = {}, {}
    for graphed in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _graphs(graphed):
            outs[graphed] = e._score(qs, hyp, explore_in["K"], shared=shared)
        torch.cuda.synchronize()
        secs[graphed] = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
    print(f"[explore eager] one _score pass of round 1's draw ({len(qs)} of its "
          f"{e.n_sample_qposes} candidates x {e.n_hypotheses}, "
          f"{'shared' if shared else 'exact'}): graphed {secs[True]:.3f} s, "
          f"eager {secs[False]:.3f} s ({secs[False] / secs[True]:.2f}x); variance, "
          f"feasibility and overflow bit-identical: {same}; {e.last_bin_states} bin states "
          f"({GPU})")
    if not same:
        raise AssertionError("the graphed _score differs from the eager one")
    return row


# The benchmark's two cells (hec_bench/workloads) whose bin_count inputs
# binner_phase takes from a real bin state, and the seeds that draw them.
BIN_CELLS = (("explore", "franka-1080p.explore-wide", 8200000777),
             ("calib", "xarm7-720p.calib", 8100000777))


def _bin_count_args(r, T, lp, K):
    """bin_count's arguments in r.bin_state(T, lp, K) (render/fused.py's
    call), flat [B, F] as render/binning.py::bin_count hands them on."""
    import easyhec_torch.render.fused as rf

    got, real = {}, rf.bin_count

    def rec(*a, **kw):
        got["a"], got["kw"] = a, kw
        return real(*a, **kw)

    rf.bin_count = rec
    try:
        r.bin_state(T, lp, K)
    finally:
        rf.bin_count = real
    a, kw = got["a"], got["kw"]
    F = a[4].shape[-1]
    flat = [None if x is None else x.reshape(-1, F).contiguous() for x in a]
    return flat + [kw[k] for k in ("H", "W", "tile_h", "tile_w", "cap", "ry", "rx", "big_k")]


@functools.lru_cache(maxsize=None)
def _cell_bin_state(kind, name, seed):
    """(renderer, pose, link poses, K) of one bin state of a benchmark cell at
    its shapes: the explorer's scoring batch at the history's first pose, or
    the calibration's capture set 0 at 0.01 off its ground truth (made once
    a process: binner_phase and rebin_phase share it)."""
    import torch

    from easyhec_torch.geometry import se3
    from hec_bench import harness as hb
    from hec_bench.traffic.calib import Calib
    from hec_bench.traffic.explore import Explore

    wl = hb.cell(name)
    cfg = hb.config(wl["config"])
    if kind == "explore":
        x = Explore(cfg, wl, seed, DEVICE)
        r, _, lp, K, _ = x.scoring_batch()
        T = se3.exp(torch.as_tensor(x.history[0], device=DEVICE))
    else:
        r, dof, lp, K, _ = Calib(cfg, wl, seed, DEVICE).loss_inputs()
        T = se3.exp(dof + 0.01)
    return r, T, lp, K


# The benchmark's rig cell, whose data rank 0 binner_phase and rebin_phase
# bin in each of its two bands, and the bank seed of its captures.
RIG_CELL = ("c5-rig-1080p.calib-4card", 0)


@functools.lru_cache(maxsize=None)
def _rig_band_state(band):
    """(renderer, pose, link poses, K) of one rank's bin state in the rig
    cell on one card: data rank 0's 40 frame-views of the cell's first rig
    (hec_bench's set-up: rig.capture_rig from the bank's seed) in image band
    `band` (540 rows; the principal point shifted by the band's first row,
    as parallel/sharding.py::_band_K does), at 0.01 off the ground truth."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.parallel.sharding import _band_K
    from hec_bench import harness as hb
    from hec_bench import rig, scene
    from hec_bench.traffic.calib import renderer

    name, bank = RIG_CELL
    cfg = hb.config(hb.cell(name)["config"])
    n_data, n_tile = int(cfg["mesh"]["data"]), int(cfg["mesh"]["tile"])
    arm = scene.arm(cfg)
    s = rig.capture_rig(cfg, arm, None, scene.rng(bank, 1, 0), masks=False)
    lp = torch.as_tensor(s["lp"].astype(np.float32), device=DEVICE)
    lp = lp[: lp.shape[0] // n_data]
    bh = cfg["H"] // n_tile
    r = renderer(cfg, [arm.meshes[n] for n in arm.names], bh, cfg["W"], DEVICE)
    K = torch.as_tensor(scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"]),
                        dtype=torch.float32, device=DEVICE)
    dof = torch.as_tensor(s["xi"], dtype=torch.float32, device=DEVICE)
    return r, se3.exp(dof + 0.01), lp, _band_K(K, band * bh)


def _bin_state_cases(main_renderer, lp, K, xi, explore_in):
    """[(kind, what, make)]: make() gives (renderer, pose, link poses, K) of
    one real bin state on the main path: the benchmark cells' (the wide
    explore cell's scoring batch, the xarm7 calibration's rebin, the rig
    cell's two bands) and this smoke's (the main compact route's, the
    online loop's explorer at its history's first pose, joints mid-range)."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import se3

    e = explore_in["explorer"]
    hist = explore_in["history"]

    def smoke_explore():
        mid = np.asarray(e.chain.joint_limits, np.float32).mean(axis=1)
        lp_e = e.chain.fk(torch.as_tensor(np.tile(mid, (e.score_batch, 1)), device=DEVICE))
        lp_e = lp_e[:, torch.as_tensor(e.link_idx, device=DEVICE).long()]
        return (e.renderer, se3.exp(torch.as_tensor(hist[0], device=DEVICE)), lp_e,
                torch.as_tensor(explore_in["K"], device=DEVICE))

    cases = [(kind, name, lambda kind=kind, name=name, seed=seed:
              _cell_bin_state(kind, name, seed)) for kind, name, seed in BIN_CELLS]
    cases += [(f"rig band {b}", f"{RIG_CELL[0]}, data rank 0",
               lambda b=b: _rig_band_state(b)) for b in (0, 1)]
    cases += [
        ("smoke main", "main compact route",
         lambda: (main_renderer, se3.exp(xi + 0.01), lp, K)),
        ("smoke explore", "online loop's explorer", smoke_explore),
    ]
    return cases


def _rebin_args(r, T, lp, K):
    """The arguments render/fused.py hands to the triangle setup and to the
    compact pack in r.bin_state(T, lp, K): {wrapper name: args}."""
    import easyhec_torch.render.fused as rf

    got, real = {}, rf.dispatch

    def rec(cuda_fn, plain_fn, *a):
        got[cuda_fn.__name__] = a
        return real(cuda_fn, plain_fn, *a)

    rf.dispatch = rec
    try:
        r.bin_state(T, lp, K)
    finally:
        rf.dispatch = real
    return got


def rebin_phase(main_renderer, lp, K, xi, explore_in):
    """The bin state's triangle setup and compact pack (ops/rebin.py: one
    kernel, then the binner, then two) on a real bin state's inputs at every
    shape the main path gives them (_bin_state_cases: the benchmark cells'
    explore, calib and rig bands, hec_bench's set-up drawing them, and this
    smoke's main compact route and online explorer): each equal to its
    plain version (render/fused.py's _tri_setup_plain, _compact_pack_plain)
    on the same card tensors bit for bit, and a second launch bit-identical.
    At the explore and calib cells' shapes each is timed (CUDA events) and
    bounded by its bytes (the setup: its inputs read once, the bboxes,
    validity and field table written; the pack: the counts, the live slots'
    list entries and fields read once, the records and chunk map written);
    at the cells' shapes the whole bin state's device time is printed.
    Returns the four kernels-line rows, "tri_setup explore|calib" and
    "compact_pack explore|calib"."""
    import torch

    from easyhec_torch.ops.rebin import compact_pack_cuda, tri_setup_cuda
    from easyhec_torch.render.fused import _compact_pack_plain, _tri_setup_plain

    def flat(out):  # (box, valid, fields) or the pack's tuple -> tensors
        return [t for x in out for t in (x if isinstance(x, tuple) else (x,))
                if t is not None]

    def nb(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []
    for kind, name, make in _bin_state_cases(main_renderer, lp, K, xi, explore_in):
        r, T, lp_c, K_c = make()
        args = _rebin_args(r, T, lp_c, K_c)
        sa, pa = args["tri_setup_cuda"], args["compact_pack_cuda"]
        counts = pa[0]
        live = int(counts.sum())
        B, T_ = counts.shape
        for tag, cuda_fn, plain_fn, a in (("tri_setup", tri_setup_cuda, _tri_setup_plain, sa),
                                          ("compact_pack", compact_pack_cuda,
                                           _compact_pack_plain, pa)):
            want, got, again = (flat(f(*a)) for f in (plain_fn, cuda_fn, cuda_fn))
            torch.cuda.synchronize()
            equal = all(w.dtype == g.dtype and torch.equal(w, g) for w, g in zip(want, got))
            same = all(torch.equal(g, h) for g, h in zip(got, again))
            print(f"[rebin] {kind} {tag} ({name}): {B} frames, {T_} tiles, {live} live slots; "
                  f"equal to the plain version {equal}; a second launch bit-identical {same}")
            if not (equal and same and len(want) == len(got)):
                raise AssertionError(f"[rebin] {kind} {tag} differs from the plain version "
                                     f"or from itself")
            if kind not in ("explore", "calib"):
                continue
            if tag == "tri_setup":
                corners, _, link, cam, base, Km = a[:6]
                nbytes = nb((corners, link, cam, base, Km)) + nb(got)
                kernel = "tri_setup_kernel"
            else:
                fields = a[3]
                rec_b = min(fields.numel() * 4, 12 * 4 * live)
                nbytes = nb((counts, a[1])) + 4 * live + rec_b + nb(got)
                kernel = "compact_gather_kernel"
            rows.append(_row(f"{tag} {kind}", f"{tag} {kind}", "easyhec_torch/ops/csrc/rebin.cu",
                             "easyhec_tpu/render/fused.py", 0.0,
                             lambda f=cuda_fn, a=a: f(*a), lambda f=plain_fn, a=a: f(*a),
                             nbytes, 0, kernel))
        if kind.startswith("smoke"):
            continue
        ms = _time_ms(lambda: r.bin_state(T, lp_c, K_c), 20)
        print(f"[rebin] {kind} bin_state {ms:.4f} ms on the device (setup, binner, pack and "
              f"the camera-from-link product; CUDA events over 20 calls) ({GPU})")
    return rows


STEP_CASES = (("calib", lambda: _cell_bin_state("calib", "xarm7-720p.calib", 8100000777)),
              ("rig", lambda: _rig_band_state(0)))


def _step_inputs(r, T, lp_c, K_c):
    """The step kernels' inputs on one real bin state at a cell's shapes: the
    scan's buffers, a _KernelStep (weights 1/B; the reference the state's
    own silhouette shifted 3 px right, so the loss and its gradient are
    real), the probes and the pixels of the state's build pose."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models import calib
    from easyhec_torch.ops import step
    from easyhec_torch.render.fused import silhouette_compact
    from easyhec_torch.solver.optim import make_optimizer

    st = r.bin_state(T, lp_c, K_c)
    target = torch.roll((silhouette_compact(r, T, K_c, st) > 0.5).float(), 3, dims=-1)
    B = target.shape[0]
    k = calib._KernelStep(r, lp_c, K_c, calib.tile_masks(target, r), 1.0,
                          torch.full((B,), 1.0 / B, device=DEVICE))
    k.probes = calib.drift_probe_points(r, lp_c).contiguous()
    f32 = dict(dtype=torch.float32, device=DEVICE)
    dof = se3.log(T).contiguous()
    b = dict(Tc=torch.zeros(4, 4, **f32), cam=torch.zeros(B, 16, **f32),
             jac=torch.zeros(12, 6, **f32), pix=torch.zeros(k.probes.shape[0], 2, **f32))
    step.step_head_plain(dof, k.K, b["Tc"], b["cam"], b["jac"], k.probes, b["pix"])
    opt = make_optimizer("adam", max_lr=3e-3, total_steps=1000)
    return k, st, dof, b, opt


def step_phase():
    """[step]: the calibration step's three kernels (ops/step.py: the head,
    the grad, the update) at the benchmark's calib cell's shape (10 frames of
    1280x720, 1800 tiles of 16x32, 384 chunks) and at the rig cell's band
    (data rank 0's 40 frame-views of 1920x540, 510 tiles of 16x64, 400
    chunks), on a real bin state and K2f/K2b's real partials, each against
    its plain twin on the same card tensors: the head's pose, camera rows,
    Jacobian and probe pixels, the grad's [loss, g] (and a second launch bit
    for bit, its ticket left at zero), five Adam updates with the drift test
    (pose, leaves, traces, step index and flag). Each kernel's CUDA-event
    time, its twin's, its bytes bound and ptxas report: six kernels-line
    rows, "step_head|step_grad|step_update calib|rig". Launch latency, not
    bytes, bounds them."""
    import torch

    from easyhec_torch.ops import step
    from easyhec_torch.render.fused import loss_parts

    def rel(a, c):
        return float((a - c).abs().max() / c.abs().max().clamp(min=1e-30))

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []
    for kind, make in STEP_CASES:
        r, T, lp_c, K_c = make()
        k, st, dof, b, opt = _step_inputs(r, T, lp_c, K_c)
        B = b["cam"].shape[0]
        # the head, at a pose off the build pose, against its twin
        d = (dof + 0.002).contiguous()
        got = {n: torch.zeros_like(b[n]) for n in ("Tc", "cam", "jac", "pix")}
        want = {n: torch.zeros_like(b[n]) for n in got}
        step.step_head_cuda(d, k.K, got["Tc"], got["cam"], got["jac"], k.probes, got["pix"])
        step.step_head_plain(d, k.K, want["Tc"], want["cam"], want["jac"], k.probes, want["pix"])
        torch.cuda.synchronize()
        errs = {n: rel(got[n], want[n]) for n in got}
        print(f"[step] {kind} head: {B} frames, {k.probes.shape[0]} probes; largest gap to "
              f"the twin over the largest magnitude {json.dumps(errs)}")
        if max(errs["Tc"], errs["cam"]) > 1e-6 or errs["jac"] > 1e-5 or errs["pix"] > 1e-6:
            raise AssertionError(f"[step] {kind} head differs from its twin: {errs}")
        # the grad on K2f's and K2b's partials at the head's camera rows
        b["cam"].copy_(got["cam"])
        lparts, parts, counts = loss_parts(r, b["cam"], st, k.ref_tiles, k.w)
        gl_k, gl_p, gl_2 = (torch.zeros(7, device=DEVICE) for _ in range(3))
        gargs = (parts, lparts, counts, k.ref_sq, k.w, got["jac"])
        step.step_grad_cuda(*gargs, gl_k, k.work)
        step.step_grad_cuda(*gargs, gl_2, k.work)
        step.step_grad_plain(*gargs, gl_p)
        torch.cuda.synchronize()
        g_err = rel(gl_k[1:], gl_p[1:])
        l_err = abs(float(gl_k[0] - gl_p[0])) / abs(float(gl_p[0]))
        print(f"[step] {kind} grad: parts {tuple(parts.shape)}, loss partials "
              f"{tuple(lparts.shape)}; loss {float(gl_k[0]):.6g} (twin {float(gl_p[0]):.6g}, "
              f"rel {l_err:.2e}), gradient rel gap {g_err:.2e}; a second launch bit-identical "
              f"{torch.equal(gl_k, gl_2)}; ticket {int(k.work[1])}")
        if l_err > 1e-5 or g_err > 1e-4 or not torch.equal(gl_k, gl_2) or int(k.work[1]):
            raise AssertionError(f"[step] {kind} grad differs from its twin or itself")
        # five updates with the drift test, kernel and twin from the same state
        n = 1000
        runs = {}
        for name, fn in (("kernel", step.step_update_cuda), ("twin", step.step_update_plain)):
            u = dict(dof=d.clone(), leaves=[t.clone().to(DEVICE) for t in opt.leaves(opt.init(d))],
                     losses=torch.zeros(n, device=DEVICE), history=torch.zeros(n, 6, device=DEVICE),
                     idx=torch.zeros(1, dtype=torch.int64, device=DEVICE),
                     need=torch.zeros((), dtype=torch.bool, device=DEVICE),
                     inner=torch.ones((), dtype=torch.int64, device=DEVICE))
            flags = []
            for i in range(5):
                fn(gl_p * (1.0 + 0.1 * i), 1.0, opt, u["leaves"], u["dof"], u["losses"],
                   u["history"], u["idx"], u["need"], u["inner"],
                   (k.probes, k.K, b["pix"], 2.0))
                flags.append(bool(u["need"]))
            runs[name] = (u, flags)
        (uk, fk), (up, fp) = runs["kernel"], runs["twin"]
        u_err = max(rel(uk["dof"], up["dof"]), rel(uk["history"][:5], up["history"][:5]),
                    *(rel(a.float(), c.float()) for a, c in zip(uk["leaves"], up["leaves"])))
        print(f"[step] {kind} update: five Adam steps with the drift test (budget 2 px): "
              f"largest rel gap {u_err:.2e}; flags {fk} (twin {fp}); step index "
              f"{int(uk['idx'])}")
        if u_err > 1e-6 or fk != fp or int(uk["idx"]) != 5 or not torch.equal(
                uk["losses"][:5], up["losses"][:5]):
            raise AssertionError(f"[step] {kind} update differs from its twin")
        # timings, with the bytes each kernel must move
        P = k.probes.shape[0]
        hb = nb(d, k.K, got["Tc"], got["cam"], got["jac"])
        gb = nb(*[t for t in gargs if t is not None], gl_k)
        ub = nb(gl_k, d, *uk["leaves"]) * 2 + 4 + 24 + nb(k.probes, b["pix"], k.K)

        def update(fn, u=uk):  # the traces hold n = 1000 steps, more than the timing runs
            fn(gl_p, 1.0, opt, u["leaves"], u["dof"], u["losses"], u["history"], u["idx"],
               u["need"], u["inner"], (k.probes, k.K, b["pix"], 2.0))

        src = "easyhec_torch/ops/csrc/step.cu"
        rep = "none (XLA fuses easyhec_tpu/models/calib.py's scan body)"
        rows.append(_row(f"step_head {kind}", f"step_head {kind}", src, rep, errs["jac"],
                         lambda: step.step_head_cuda(d, k.K, got["Tc"], got["cam"], got["jac"]),
                         lambda: step.step_head_plain(d, k.K, want["Tc"], want["cam"],
                                                      want["jac"]),
                         hb, 0, "step_head_kernel"))
        rows.append(_row(f"step_grad {kind}", f"step_grad {kind}", src, rep, g_err,
                         lambda: step.step_grad_cuda(*gargs, gl_k, k.work),
                         lambda: step.step_grad_plain(*gargs, gl_p), gb, 0, "step_grad_kernel"))
        rows.append(_row(f"step_update {kind}", f"step_update {kind}", src, rep, u_err,
                         lambda: update(step.step_update_cuda),
                         lambda: update(step.step_update_plain, up), ub, 0,
                         "step_update_kernel"))
        print(f"[step] {kind}: a step's K2f + K2b (with their output fills) for scale: "
              f"{_time_ms(lambda: loss_parts(r, b['cam'], st, k.ref_tiles, k.w), 20):.4f} ms ({GPU})")
    return rows


def binner_phase(main_renderer, lp, K, xi, explore_in):
    """The binner's counting sort (ops/binning.py::bin_count_cuda, four
    kernels) against its plain version (render/binning.py::_bin_count_flat)
    on the same card tensors: the inputs of a real bin state at every
    shape the main path gives it (_bin_state_cases: the benchmark cells'
    explore, calib and rig bands, and this smoke's main compact route and
    online explorer). idx,
    counts, q and overflow must be equal, and equal again on a second
    launch. At the cells' shapes it is timed and bounded by its bytes: the
    inputs read once, idx, counts, q and overflow written whole. Returns
    the two kernels-line rows, "bin_count explore" and "bin_count calib"."""
    import torch

    from easyhec_torch.ops.binning import bin_count_cuda
    from easyhec_torch.render.binning import _bin_count_flat

    rows = []
    for kind, what, make in _bin_state_cases(main_renderer, lp, K, xi, explore_in):
        args = _bin_count_args(*make())
        want = _bin_count_flat(*args)
        got, again = bin_count_cuda(*args), bin_count_cuda(*args)
        torch.cuda.synchronize()
        equal = {n: bool(torch.equal(w, g)) for n, w, g in zip(want._fields, want, got)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        B, F = args[4].shape
        H, W, th, tw, cap, ry, rx, big_k = args[6:]
        Kc = want.idx.shape[1] * want.idx.shape[2]
        real = int((want.q < Kc).sum())
        print(f"[binner] {kind} ({what}): {B} frames of {F} triangles, {W}x{H}, tiles "
              f"{th}x{tw}, cap {cap}, rect {ry}x{rx}, big_k {big_k}, row classes "
              f"{args[5] is not None}; {real} entries placed, max tile count "
              f"{int(want.counts.max())}, overflow {want.overflow.tolist()}; equal to the "
              f"plain version {json.dumps(equal)}; a second launch bit-identical {same}")
        if not all(equal.values()) or not same:
            raise AssertionError(f"[binner] {kind}: the kernels differ from the plain version "
                                 f"or from themselves")
        if kind not in ("explore", "calib"):
            continue
        nbytes = (sum(a.numel() * a.element_size() for a in args[:6] if a is not None)
                  + sum(t.numel() * t.element_size() for t in want))
        rows.append(_row(f"bin_count {kind}", f"binner {kind}",
                         "easyhec_torch/ops/csrc/binning.cu",
                         "easyhec_tpu/render/binning.py:275", 0.0,
                         lambda: bin_count_cuda(*args), lambda: _bin_count_flat(*args),
                         nbytes, 0, "bin_place_kernel"))
    return rows


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


# ---- multi-rank calibration (easyhec_torch.parallel) -------------------------

C5_H, C5_W, C5_F = 1080, 1920, 1400.0  # config (5): scripts/config5_chip.py:48-93
C5_VIEWS, C5_FRAMES = 4, 20  # ring views x frames: 80 frame-views
C5_DATA, C5_TILE = 2, 2  # the (data x tile) mesh: 40 frame-views and 540 rows a rank
C5_TH, C5_TW, C5_MARGIN = 16, 64, 4.0
C5_OFFSET = [0.01, -0.01, 0.01, 0.005, -0.005, 0.01]  # the script's start offset
C5_STEPS = 1000  # [parallel 2x2]'s steps, both runs
C5_WORKER_S = 900  # the 2x2 ranks' time limit


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _compact_k():
    from easyhec_torch.ops import pose_raster_compact as prc

    return {"loss_fwd_compact": prc.loss_fwd_compact_cuda,
            "loss_bwd_compact": prc.loss_bwd_compact_cuda}


def _held(tag, losses, dof, history, ref, early_trace=True):
    """A sharded run against the one-rank calibrate `ref`. Always held: the
    loss at every step whose pose is still bit-identical to the one-rank
    run's within 1e-5 relative (the same inputs; the band split changes only
    the summation order), and the final pose within JAX's atol 5e-3
    (tests/test_sharding.py). early_trace also holds JAX's early-trace
    tolerance, the first 10 losses within rtol 3e-3 and atol 1e-3; where
    it is not held its worst ratio is printed: once the poses part by an
    ulp, Adam and the loss's steepness amplify the gap (PERF.md §6)."""
    import numpy as np

    l10 = np.abs(losses[:10] - ref.losses[:10])
    lim = 1e-3 + 3e-3 * np.abs(ref.losses[:10])
    dh = np.abs(history - ref.history).max(axis=1)
    same = int(np.argmax(dh > 0)) if (dh > 0).any() else len(dh)
    rel_same = float((np.abs(losses[:same] - ref.losses[:same])
                      / np.abs(ref.losses[:same])).max()) if same else 0.0
    ddof = float(np.abs(dof - ref.dof).max())
    print(f"[{tag}] first 10 steps: loss relative difference "
          + np.array2string(l10 / np.abs(ref.losses[:10]), precision=2, max_line_width=200)
          + "; pose difference before the step "
          + np.array2string(dh[:10], precision=2, max_line_width=200))
    print(f"[{tag}] against the one-rank calibrate: poses bit-identical for the first "
          f"{same} steps, their losses within {rel_same:.3e} relative (tol 1e-5); first 10 "
          f"losses max abs diff {l10.max():.3e} (JAX's tol 1e-3 + 3e-3*|ref|, worst ratio "
          f"{(l10 / lim).max():.3f}, {'held' if early_trace else 'printed'}); final dof max "
          f"abs diff {ddof:.3e} (tol 5e-3); final losses {losses[-1]:.4f} and "
          f"{ref.losses[-1]:.4f}")
    if not (same >= 1 and rel_same <= 1e-5 and ddof <= 5e-3
            and (not early_trace or (l10 <= lim).all())):
        raise AssertionError(f"[{tag}] the sharded run leaves its tolerances")


def nccl_capture_check():
    """One NCCL all_reduce captured in a CUDA graph and replayed: at world 1
    sharded_calibrate's _all_reduce issues no collective, so this is the
    capture a wider NCCL mesh's graphed step relies on. The reduction is
    premultiplied by 2, so each replay shows. -> the buffer after 3
    replays of arange(4)."""
    import torch
    import torch.distributed as dist

    buf = torch.arange(4.0, device=DEVICE)
    op = dist._make_nccl_premul_sum(2.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up before the capture
        dist.all_reduce(buf, op=op)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        dist.all_reduce(buf, op=op)
    buf.copy_(torch.arange(4.0, device=DEVICE))
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    got = buf.tolist()
    print(f"[parallel nccl] an NCCL all_reduce (premul_sum 2) captured in a CUDA graph, "
          f"replayed 3 times on arange(4): {got}")
    if got != [0.0, 8.0, 16.0, 24.0]:
        raise AssertionError("[parallel nccl] the captured NCCL all_reduce did not run")


def parallel_nccl_phase(renderer, lp, K, xi, target, steps):
    """[parallel nccl]: an NCCL process group of one rank and the (1, 1)
    DeviceMesh; sharded_calibrate (graphed: one scan a call, its step a
    CUDA graph) against calibrate on the bench scene's compact route, and
    against itself eager (_graphs) bit for
    bit, all in this phase, each on the kernel route (_check_step_kernels,
    shard.call's kernel_steps); then nccl_capture_check. Returns the graphed
    sharded run's launches, the step kernels' among them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.parallel import comm, init_distributed, make_mesh, sharded_calibrate
    from easyhec_torch.utils import profiling

    init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0,
                     backend="nccl")
    try:
        t = torch.arange(4.0, device=DEVICE)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        mesh = make_mesh(1, 1)
        print(f"[parallel nccl] backend {dist.get_backend()}, world {dist.get_world_size()}, "
              f"mesh {type(mesh).__name__} {tuple(mesh.shape)} {mesh.mesh_dim_names}; NCCL "
              f"all_reduce {t.tolist()}; comm {comm.all_gather_objects('rank0')}")
        if t.tolist() != [0.0, 1.0, 2.0, 3.0] or comm.process_count() != 1:
            raise AssertionError("[parallel nccl] one-rank collectives are not identities")
        d0 = (xi + 0.01).cpu().numpy()
        kern = _compact_k()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = calibrate(d0, renderer, lp, K, target, num_steps=steps, max_lr=3e-3,
                        rebin_every=0)
        torch.cuda.synchronize()
        ms_ref = (time.perf_counter() - t0) / steps * 1e3
        runs, ms = {}, {}
        for graphed in (True, False):
            _reset(kern)
            _reset(_step_kernels())
            t0 = time.perf_counter()
            with _graphs(graphed):
                runs[graphed] = sharded_calibrate(d0, renderer, mesh, lp, K, target,
                                                  num_steps=steps, max_lr=3e-3, rebin_every=0)
            torch.cuda.synchronize()
            ms[graphed] = (time.perf_counter() - t0) / steps * 1e3
            call = [sp for sp in profiling.spans() if sp.name == "shard.call"][-1]
            step_launches = _check_step_kernels("parallel nccl", steps,
                                                call.counts["own_rebins"],
                                                call.counts["kernel_steps"], True)
            if graphed:
                launches = {k: fn.launches for k, fn in kern.items()}
                graphed_steps = step_launches
        nccl_capture_check()
    finally:
        dist.destroy_process_group()
    dof, losses, history = runs[True]
    same = all(torch.equal(a, b) for a, b in zip(runs[True], runs[False]))
    losses, dof = losses.cpu().numpy(), dof.cpu().numpy()
    print(f"[parallel nccl] {steps} steps: sharded_calibrate {ms[True]:.3f} ms/step, calibrate "
          f"{ms_ref:.3f} ms/step ({GPU}); launches {json.dumps(launches)}")
    print(f"[parallel nccl] sharded_calibrate graphed {ms[True]:.3f} ms/step against eager "
          f"{ms[False]:.3f} (eager / graphed {ms[False] / ms[True]:.2f}x); losses, history "
          f"and pose bit-identical: {same}")
    if not same:
        raise AssertionError("[parallel nccl] the graphed sharded run differs from the eager")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("[parallel nccl] non-finite or rising loss")
    _held("parallel nccl", losses, dof, history.cpu().numpy(), ref)
    if list(launches.values()) != [steps, steps]:
        raise AssertionError(f"[parallel nccl] launches {launches} for {steps} steps")
    return {**launches, **graphed_steps}


def config5_scene():
    """Config (5)'s widths (scripts/config5_chip.py:48-93) on the mini arm
    (the xArm7 is not in the repo): 4 ring views (radius 1.2, height 0.8,
    target [0, 0, 0.3]) x 20 frames at 1920x1080, f = 1400, qposes uniform
    in 0.4x the joint limits (numpy seed 0). Each view's offset is folded
    into the link poses as the script does (lp' = inv(Tc0) Tc_v lp), so one
    pose, camera 0's, is solved over the 80 frame-views.
    Returns (meshes, lp [80, L, 4, 4], K, xi_gt) on the card."""
    import numpy as np
    import torch

    from easyhec_torch.geometry import camera, se3
    from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
    from easyhec_torch.robot.mesh import subdivide_to_max_edge

    model = parse_urdf(ROOT / "assets" / "mini_arm.urdf")
    chain = build_chain(model)
    names = ["base", "upper", "fore"]
    meshes = load_link_meshes(model, link_names=names)
    mesh_list = [subdivide_to_max_edge(meshes[n], 0.008) for n in names]
    Tcs = se3.inverse(camera.ring_poses(C5_VIEWS, 1.2, 0.8,
                                        target=torch.tensor([0.0, 0.0, 0.3])))
    lim = chain.joint_limits * 0.4
    qs = np.random.default_rng(0).uniform(lim[:, 0], lim[:, 1], (C5_FRAMES, chain.n_dof))
    lp1 = chain.fk(torch.tensor(qs, dtype=torch.float32))[:, [chain.link_index(n)
                                                              for n in names]]
    offs = torch.einsum("ij,vjk->vik", se3.inverse(Tcs[0]), Tcs)
    lp = torch.einsum("vij,fljk->vflik", offs, lp1).reshape(-1, len(names), 4, 4)
    K = torch.tensor([[C5_F, 0, C5_W / 2], [0, C5_F, C5_H / 2], [0, 0, 1]])
    return mesh_list, lp.to(DEVICE), K.to(DEVICE), se3.log(Tcs[0]).to(DEVICE)


def _c5_audit(mesh_list, lp, K, xis):
    """The scene's bin loads under each pose of xis, over the full image and
    each band (the band's grid starts at its own first row): the largest
    tile load, count of triangles outside the 2x1-tile span class (big_k),
    tile span in rows and columns, and chunks of 128 slots per frame (ncu),
    counted as the counting binner counts them (the margin-dilated bboxes of
    the valid, on-screen, front-facing triangles)."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.render import RobotRenderer, TileConfig
    from easyhec_torch.render.projection import setup_triangles_corners

    r = RobotRenderer(mesh_list, C5_H, C5_W, tile=TileConfig(C5_TH, C5_TW), device=DEVICE)
    a = dict(load=0, big=0, span_y=0, span_x=0, ncu=0)
    bh = C5_H // C5_TILE
    for xi in xis:
        Tc_c2l = torch.einsum("ij,bljk->blik", se3.exp(xi), lp)
        for h, y0 in [(C5_H, 0)] + [(bh, t * bh) for t in range(C5_TILE)]:
            Kb = K.clone()
            Kb[1, 2] -= y0
            tris = setup_triangles_corners(r.corners_rest, r.face_link_onehot, Tc_c2l, Kb,
                                           cull_backfaces=True)
            m = C5_MARGIN
            lox, hix = tris.u.amin(-2) - m, tris.u.amax(-2) + m
            loy, hiy = tris.v.amin(-2) - m, tris.v.amax(-2) + m
            n_ty, n_tx = -(-h // C5_TH), -(-C5_W // C5_TW)
            use = tris.valid & (hix > 0) & (lox < C5_W) & (hiy > 0) & (loy < h)
            ty0 = torch.clamp(torch.floor(loy / C5_TH).long(), 0, n_ty - 1)
            ty1 = torch.clamp(torch.floor(hiy / C5_TH).long(), 0, n_ty - 1)
            tx0 = torch.clamp(torch.floor(lox / C5_TW).long(), 0, n_tx - 1)
            tx1 = torch.clamp(torch.floor(hix / C5_TW).long(), 0, n_tx - 1)
            sy, sx = ty1 - ty0 + 1, tx1 - tx0 + 1
            big = use & ((sy > 2) | (sx > 1))
            bi = torch.arange(use.shape[0], device=DEVICE)[:, None].expand_as(use)[use]
            d = torch.zeros((use.shape[0], n_ty + 1, n_tx + 1), dtype=torch.long,
                            device=DEVICE)
            for yy, xx, sgn in ((ty0, tx0, 1), (ty0, tx1 + 1, -1), (ty1 + 1, tx0, -1),
                                (ty1 + 1, tx1 + 1, 1)):
                d.index_put_((bi, yy[use], xx[use]),
                             torch.full_like(bi, sgn), accumulate=True)
            loads = d.cumsum(1).cumsum(2)[:, :n_ty, :n_tx]
            a["load"] = max(a["load"], int(loads.max()))
            a["big"] = max(a["big"], int(big.sum(-1).max()))
            a["span_y"] = max(a["span_y"], int(sy[use].max()))
            a["span_x"] = max(a["span_x"], int(sx[use].max()))
            a["ncu"] = max(a["ncu"], int((-(-loads // 128)).sum((1, 2)).max()))
    return a


def config5_tile(audit):
    """The 1080p tile config of config (5) (16x64 tiles, margin 4, compact
    chunks and the boundary-prefix map at 400, row-subsorted counting bins,
    culling, band-only backward) with capacities from the audit and the
    script's headroom policy against drift: cap and big_k 1.3x the audit
    (rounded up to 128 and 256), the rect window 2 rows and 1 column over
    the widest span, and the chunk budget 400 unless 1.3x the audit's ncu
    needs more."""
    import math

    nc = max(400, math.ceil(1.3 * audit["ncu"]))
    return dict(tile_h=C5_TH, tile_w=C5_TW, capacity=128 * math.ceil(1.3 * audit["load"] / 128),
                binner="count", rect_y=audit["span_y"] + 2, rect_x=audit["span_x"] + 1,
                margin=C5_MARGIN, cull_backfaces=True, fused=True, bwd_band_only=True,
                bin_big_k=256 * math.ceil(1.3 * audit["big"] / 256), bin_subsort_rows=True,
                compact_chunks=nc, bwd_chunks=nc)


def parallel_band_kernel_phase(mesh_list, tile, lp, K, d0, target):
    """[parallel band kernels]: K2f, K2b (on the boundary-prefix map) and K3
    on the tile-1 band of config (5) (rows 540-1079: the principal point
    shifted to cy - 540 = 0, the band's top edge) for data rank 0's 40
    frame-views at the start
    pose, against their plain versions as [kernels] holds them; returns
    their kernels-line rows."""
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import tile_masks
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops.pose_raster import loss_cotangent
    from easyhec_torch.parallel.sharding import _band_K
    from easyhec_torch.render import RobotRenderer, TileConfig
    from easyhec_torch.render.fused import cam_rows

    bh = C5_H // C5_TILE
    nb = lp.shape[0] // C5_DATA
    band = RobotRenderer(mesh_list, bh, C5_W, tile=TileConfig(**tile), device=DEVICE)
    Kb = _band_K(K, bh)
    lpb = lp[:nb]
    Tc = se3.exp(torch.as_tensor(d0, device=DEVICE))
    st = band.bin_state(Tc, lpb, Kb)  # K3 builds the boundary-prefix map
    if bool(st.overflow):
        raise AssertionError("[parallel band kernels] bin overflow at the start pose")
    cam = cam_rows(Tc, Kb, nb).contiguous()
    ref = tile_masks(target[:nb, bh:], band).contiguous()
    n_tx = -(-C5_W // C5_TW)
    meta = prc.Meta(C5_TH, C5_TW, n_tx, bh, C5_W, 1.0, 0.001, 10.0, True)
    tag = "band 1"
    print(f"[parallel band kernels] {nb} frame-views of {C5_W}x{bh}, cy {float(Kb[1, 2]):.1f}; "
          f"loads max tile {int(st.counts.max())} (cap {tile['capacity']}), max ncu "
          f"{int(st.ncu.max())}, backward chunks {int((st.bwd_nlive > 0).sum())} (budget "
          f"{tile['bwd_chunks']} a frame)")
    fargs = (cam, st.rec, st.nlive, st.ctmap, st.ncu, ref, meta)
    got = prc.loss_fwd_compact_cuda(*fargs)
    f_err = _check_loss_fwd(f"K2f {tag}", got, prc.loss_fwd_compact_plain(*fargs))
    _check_repeat(f"K2f {tag}", lambda: _fwd_out(prc.loss_fwd_compact_cuda(*fargs)))
    gb = torch.full((nb,), 1.0 / nb, device=DEVICE)
    bargs = (cam, st.rec, st.bwd_nlive, st.bwd_ctmap, st.bwd_cpos, ref, got[1], gb, meta)
    b_err = _check_dcam(f"K2b {tag}", prc.loss_bwd_compact_cuda(*bargs).sum(1),
                        prc.loss_bwd_compact_plain(*bargs).sum(1))
    _check_repeat(f"K2b {tag}", lambda: prc.loss_bwd_compact_cuda(*bargs).sum(1))
    check_tile_acc(f"K3 {tag}", cam, st, C5_TH, C5_TW, H=bh, W=C5_W)

    T, P, nc = ref.shape[1], C5_TH * C5_TW, st.nlive.shape[1]
    frames = [(prc._chunks_of(st.rec[b]), st.ctmap[b].long(), st.nlive[b].long())
              for b in range(nb)]
    gp = loss_cotangent(got[1].reshape(nb, T, P), ref.reshape(nb, T, P), gb[:, None, None],
                        torch.arange(T, device=DEVICE), meta)
    w = _needed_work(cam, frames, {"K2b": gp}, meta)
    _print_work(f"compact {tag}", w)
    maps = nb * (nc * 8 + 4 + 64)
    src = "easyhec_torch/ops/csrc/pose_raster_compact.cu"
    shape = f"{C5_W}x{bh} band"
    return [
        _row(f"loss_fwd_compact {shape}", f"K2f {tag}", src,
             "easyhec_tpu/ops/pose_raster_compact.py:66", f_err,
             lambda: prc.loss_fwd_compact_cuda(*fargs), lambda: prc.loss_fwd_compact_plain(*fargs),
             w["fwd"][1] * SLOT_BYTES + w["tiles"] * P * 4 + nb * T * (P + 1) * 4 + maps,
             _ops(w["fwd"], OPS_FWD_PAIR, OPS_FWD_LANE), "loss_fwd_compact_kernel"),
        _row(f"loss_bwd_compact {shape}", f"K2b {tag}", src,
             "easyhec_tpu/ops/pose_raster_compact.py:105", b_err,
             lambda: prc.loss_bwd_compact_cuda(*bargs), lambda: prc.loss_bwd_compact_plain(*bargs),
             w["K2b"][1] * SLOT_BYTES + w["tiles"] * 2 * P * 4 + maps + nb * nc * (4 + 48),
             _ops(w["K2b"], OPS_BWD_PAIR, OPS_BWD_LANE), "loss_bwd_compact_kernel"),
    ]


def parallel_worker(rank: int, rdv: str, work: Path) -> int:
    """One rank of [parallel 2x2] and [parallel comm] (``chip_smoke.py
    --parallel-worker RANK RDV DIR``): gloo on the card's CUDA tensors,
    rendezvous at RDV; its inputs and results are pickles in DIR."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from easyhec_torch.parallel import comm, init_distributed, make_mesh, sharded_calibrate
    from easyhec_torch.render import RobotRenderer, TileConfig
    from easyhec_torch.robot.mesh import TriMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(rdv, num_processes=C5_DATA * C5_TILE, process_id=rank, backend="gloo")
    inp = pickle.loads((work / "in.pkl").read_bytes())
    mesh = make_mesh(C5_DATA, C5_TILE)
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("tile")),
           "gather": comm.all_gather_arrays(np.full(3, rank, np.float64)),
           "objects": comm.all_gather_objects({"rank": rank, "pad": "x" * (1000 * rank)}),
           "reduced": comm.reduce_dict({"rank": float(rank), "one": 1.0}),
           "summed": comm.reduce_dict({"rank": float(rank)}, average=False)}
    comm.sync()
    band = RobotRenderer([TriMesh(v, f) for v, f in inp["meshes"]], C5_H // C5_TILE, C5_W,
                         tile=TileConfig(**inp["tile"]), device=DEVICE)
    masks = np.load(work / "target.npy").astype(np.float32)
    rebins = [0]
    bin_state = band.bin_state

    def counted(*a, **k):
        rebins[0] += 1
        return bin_state(*a, **k)

    band.bin_state = counted
    kern = _compact_k()
    torch.cuda.synchronize()
    comm.sync()
    torch.cuda.reset_peak_memory_stats()
    _reset(kern)
    t0 = time.perf_counter()
    dof, losses, hist = sharded_calibrate(inp["d0"], band, mesh, inp["lp"], inp["K"], masks,
                                          num_steps=inp["steps"], max_lr=3e-3, rebin_every=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out.update(dof=dof.cpu().numpy(), losses=losses.cpu().numpy(),
               history=hist.cpu().numpy(), ms=dt / inp["steps"] * 1e3,
               launches={k: fn.launches for k, fn in kern.items()}, rebins=rebins[0],
               peak=torch.cuda.max_memory_allocated())
    # the combine's all-reduce alone: 7 floats of the card over gloo
    buf = torch.zeros(7, device=DEVICE)
    comm.sync()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    t0 = time.perf_counter()
    for _ in range(200):
        h = buf.cpu()
        dist.all_reduce(h)
        buf.copy_(h)
    torch.cuda.synchronize()
    out["staged_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    comm.sync()
    dist.destroy_process_group()
    (work / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    return 0


def parallel_2x2_phase(steps, work):
    """[parallel band kernels], [parallel 2x2] and [parallel comm]: config
    (5)'s scene and tile config from the audit (printed); the targets
    rendered through K2f/K3 at the GT pose; calibrate of the 80 frame-views
    at full height on this rank; then 4 gloo ranks on the one card, each in
    its own process, on a (2 data x 2 tile) mesh: sharded_calibrate over 40
    frame-views and one 540-row band each, with the same steps. Holds every
    rank bit-identical; against the one-rank run, the losses while the poses
    are bit-identical and the final pose (_held; JAX's early-trace
    tolerance is printed); the pose within config (5)'s limits (0.5 cm,
    0.1 deg: scripts/config5_chip.py); no overflow; one K2b launch per
    step and one K2f per step and per rebin (K3 builds each rebin's
    boundary-prefix map); and the comm helpers across the ranks. Returns
    (band kernel rows, rank 1's launches)."""
    import os
    import pickle

    import numpy as np
    import torch

    from easyhec_torch.geometry import se3
    from easyhec_torch.models.calib import calibrate
    from easyhec_torch.render import RobotRenderer, TileConfig
    from easyhec_torch.render.fused import silhouette_compact

    t_phase = time.perf_counter()
    mesh_list, lp, K, xi = config5_scene()
    d0 = (xi + torch.tensor(C5_OFFSET, device=DEVICE)).cpu().numpy()
    audit = _c5_audit(mesh_list, lp, K, [xi, torch.as_tensor(d0, device=DEVICE)])
    tile = config5_tile(audit)
    print(f"[parallel 2x2] config (5) widths: {lp.shape[0]} frame-views of {C5_W}x{C5_H}, "
          f"f {C5_F}, {sum(m.n_faces for m in mesh_list)} triangles; bin audit at the GT and "
          f"start poses (full image and both bands): {json.dumps(audit)} -> cap "
          f"{tile['capacity']}, big_k {tile['bin_big_k']}, rect {tile['rect_y']}x"
          f"{tile['rect_x']}, compact and backward chunks {tile['compact_chunks']}")
    full = RobotRenderer(mesh_list, C5_H, C5_W, tile=TileConfig(**tile), device=DEVICE)
    with torch.no_grad():
        st = full.bin_state(se3.exp(xi), lp, K)
        if bool(st.overflow):
            raise AssertionError("[parallel 2x2] bin overflow at the GT pose")
        target = (silhouette_compact(full, se3.exp(xi), K, st) > 0.5).float()
    del st
    print(f"[parallel 2x2] target masks: {float(target.mean()):.4f} of pixels set")
    rows = parallel_band_kernel_phase(mesh_list, tile, lp, K, d0, target)

    kern = _compact_k()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kern)
    t0 = time.perf_counter()
    ref = calibrate(d0, full, lp, K, target, num_steps=steps, max_lr=3e-3, rebin_every=0,
                    Tc_c2b_gt=se3.exp(xi).cpu().numpy())
    torch.cuda.synchronize()
    ms_ref = (time.perf_counter() - t0) / steps * 1e3
    peak_ref = torch.cuda.max_memory_allocated()
    launches_ref = {k: fn.launches for k, fn in kern.items()}
    print(f"[parallel 2x2] one rank, {lp.shape[0]} frame-views at full height: {steps} steps at "
          f"{ms_ref:.3f} ms/step, {ref.rebins} rebins, peak {peak_ref / 2**30:.3f} GiB, "
          f"launches {json.dumps(launches_ref)}, loss {ref.losses[0]:.2f} -> "
          f"{ref.losses[-1]:.2f}, pose error {json.dumps(ref.metrics)} ({GPU})")
    if ref.overflow:
        raise AssertionError("[parallel 2x2] overflow in the one-rank run")
    np.save(work / "target.npy", target.to(torch.uint8).cpu().numpy())
    (work / "in.pkl").write_bytes(pickle.dumps(dict(
        meshes=[(m.vertices, m.faces) for m in mesh_list], tile=tile,
        lp=lp.cpu().numpy(), K=K.cpu().numpy(), d0=d0, steps=steps)))
    del full, target
    torch.cuda.empty_cache()

    n = C5_DATA * C5_TILE
    env = dict(os.environ, OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-worker", str(r),
         f"file://{work / 'rdv'}", str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        logs = [p.communicate(timeout=C5_WORKER_S)[0] for p in procs]
    finally:
        for p in procs:  # no rank outlives the phase
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"[parallel 2x2] rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    outs = [pickle.loads((work / f"out{r}.pkl").read_bytes()) for r in range(n)]

    # [parallel comm]
    for r, o in enumerate(outs):
        ok = (np.array_equal(o["gather"], np.repeat(np.arange(n, dtype=np.float64)[:, None],
                                                      3, 1))
              and o["objects"] == [{"rank": q, "pad": "x" * (1000 * q)} for q in range(n)]
              and o["reduced"] == {"one": 1.0, "rank": 1.5} and o["summed"] == {"rank": 6.0}
              and o["coords"] == (r // C5_TILE, r % C5_TILE))
        if not ok:
            raise AssertionError(f"[parallel comm] rank {r}: {o['gather']}, {o['reduced']}, "
                                 f"{o['summed']}, {o['coords']}")
    print(f"[parallel comm] {n} gloo ranks: all_gather_arrays, all_gather_objects (payloads "
          f"of 0-{1000 * (n - 1)} bytes of padding), reduce_dict (mean and sum, f64) and "
          "sync agree on every rank")

    # [parallel 2x2]
    o0 = outs[0]
    same = all(np.array_equal(o["dof"], o0["dof"]) and np.array_equal(o["losses"], o0["losses"])
               and np.array_equal(o["history"], o0["history"]) for o in outs)
    for r, o in enumerate(outs):
        print(f"[parallel 2x2] rank {r} (data {o['coords'][0]}, band {o['coords'][1]}): "
              f"{o['ms']:.3f} ms/step, {o['rebins']} rebins, peak {o['peak'] / 2**30:.3f} GiB, "
              f"launches {json.dumps(o['launches'])}, gloo all-reduce of 7 floats "
              f"{o['allreduce_ms']:.4f} ms ({o['allreduce_ms'] / o['ms']:.4f} of a step), "
              f"through a host copy {o['staged_ms']:.4f} ms")
        fwd, bwd = o["launches"].values()
        if bwd != steps or fwd != steps + o["rebins"]:
            raise AssertionError(f"[parallel 2x2] rank {r} launches {o['launches']} for "
                                 f"{steps} steps and {o['rebins']} rebins")
    from easyhec_torch.models.calib import pose_metrics

    err = pose_metrics(o0["dof"], se3.exp(xi).cpu().numpy())
    print(f"[parallel 2x2] {steps} steps on 4 ranks: {max(o['ms'] for o in outs):.3f} ms/step "
          f"(slowest rank) against one rank's {ms_ref:.3f}; rebins (mesh max) "
          f"{max(o['rebins'] for o in outs)}; ranks' wall {wall:.1f} s with start-up; every "
          f"rank's dof, losses and history bit-identical: {same}; loss {o0['losses'][0]:.2f} -> "
          f"{o0['losses'][-1]:.2f}; pose error {json.dumps(err)} ({GPU})")
    if not same:
        raise AssertionError("[parallel 2x2] the ranks' results differ")
    if not (np.isfinite(o0["losses"]).all() and o0["losses"][-1] < o0["losses"][0]):
        raise AssertionError("[parallel 2x2] non-finite or rising loss")
    _held("parallel 2x2", o0["losses"], o0["dof"], o0["history"], ref, early_trace=False)
    if not (err["err_trans_geodesic_cm"] < 0.5 and err["err_rot_geodesic_deg"] < 0.1):
        raise AssertionError("[parallel 2x2] the sharded pose misses config (5)'s limits "
                             "(0.5 cm, 0.1 deg)")
    print(f"[parallel 2x2] phase {time.perf_counter() - t_phase:.1f} s")
    return rows, outs[1]["launches"]


# [cli]: the port's command-line tools as a user runs them, each in a fresh
# interpreter with no --device flag (so on the card, the CLIs' default), and
# with PyYAML, JAX, OpenCV and matplotlib blocked: configs/*.yaml read by the
# port's own reader. configs/xarm7_example.yaml runs at its widths with the
# arm swapped for the mini arm (the xArm7 assets are not in the repo).
CLI_BLOCKED = ("yaml", "jax", "jaxlib", "optax", "easyhec_tpu", "cv2", "matplotlib")
CLI_X7 = ["model.urdf_path=assets/mini_arm.urdf", "model.use_links=[base, upper, fore]",
          "model.subdivide_max_edge=0.008", "model.decimate_voxel=0.0"]
# Runs ``python -c CHILD easyhec_torch.cli.<name> ARGS...`` (CHILD this
# template, filled in by _cli): blocks the host packages, runs the CLI as
# __main__, then prints the launch count of every kernel wrapper.
_CLI_CHILD = """
import json, runpy, sys
for k in {blocked!r}:
    sys.modules[k] = None  # any import of it now raises ImportError
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__")
finally:
    launches = {{}}
    for key, mod, fn in {counters!r}:
        m = sys.modules.get(mod)
        launches[key] = getattr(m, fn).launches if m else 0
    print("[launches]", json.dumps(launches), flush=True)
"""


def _cli(tag, module, args, expect, kernels, root=None, artifacts=()):
    """Run ``easyhec_torch.cli.<module> ARGS`` as a child (cwd: the
    checkout). Raises unless it exits 0, prints ``expect``, launches every
    kernel in ``kernels``, leaves ``artifacts`` under ``root`` and rebuilds no
    kernel library. Prints one ``[cli <tag>]`` line; returns (launches,
    seconds)."""
    from easyhec_torch.ops import _build

    libs = sorted(_build._build_dir().glob("*.so"))
    counters = [(k, fn.__module__, fn.__name__) for k, fn in _all_kernels().items()]
    child = _CLI_CHILD.format(blocked=CLI_BLOCKED, counters=counters)
    cmd = [sys.executable, "-c", child, f"easyhec_torch.cli.{module}", *args]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"[cli {tag}] rc {r.returncode}: {' '.join(cmd[3:])}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    tail = [ln for ln in r.stdout.splitlines() if ln.startswith("[launches] ")]
    launches = {k: n for k, n in json.loads(tail[-1].split(" ", 1)[1]).items() if n}
    held = next((ln.strip() for ln in r.stdout.splitlines() if expect in ln), None)
    missing = [a for a in artifacts if not (Path(root) / a).exists()]
    print(f"[cli {tag}] rc 0, {secs:.3f} s; {held!r}; launches {json.dumps(launches)}; "
          f"artifacts {len(artifacts) - len(missing)}/{len(artifacts)} "
          f"({', '.join(artifacts)})")
    if held is None:
        raise AssertionError(f"[cli {tag}] printed no line with {expect!r}:\n{r.stdout[-2000:]}")
    if missing:
        raise AssertionError(f"[cli {tag}] artifacts missing under {root}: {missing}")
    if not set(kernels) <= set(launches):
        raise AssertionError(f"[cli {tag}] launched {launches}, not every one of {kernels}")
    if sorted(_build._build_dir().glob("*.so")) != libs:
        raise AssertionError(f"[cli {tag}] rebuilt a kernel library: the child's build key "
                             "differs from the parent's")
    return launches, secs


RUN_ARTIFACTS = ["Tc_c2b.txt", "metrics.json", "eval.json", "config.yaml", "log.txt",
                 "checkpoints/final.npz", "checkpoints/final.json", "metrics.jsonl",
                 "error_maps.png"]


def _cli_run_held(tag, run, launches, secs, trainer_ms, fwd, bwd, limits=None, falling=True):
    """A ``cli.run`` offline run dir: no bin overflow in its log, a finite
    loss (falling unless the run starts at the GT, where Adam's first steps
    leave the minimum), one loss kernel pair a step, the run's config.yaml
    read back by the port's reader, its pose error (held to ``limits`` (cm,
    deg) when given), and its ms/step beside [trainer]'s in-process one."""
    import numpy as np

    from easyhec_torch.config import load_config

    losses = np.load(run / "checkpoints" / "final.npz")["losses"]
    wall = json.loads((run / "checkpoints" / "final.json").read_text())["wall_time_s"]
    m = json.loads((run / "metrics.json").read_text())
    cfg = load_config(run / "config.yaml")
    steps = cfg.solver.num_epochs
    overflow = [ln for ln in (run / "log.txt").read_text().splitlines() if "overflow" in ln]
    print(f"[cli {tag}] loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; "
          f"error {m['err_trans_geodesic_cm']:.4f} cm {m['err_rot_geodesic_deg']:.4f} deg"
          f"{' (limits %s cm, %s deg)' % limits if limits else ''}; wall_time_s / steps "
          f"{wall / steps * 1e3:.3f} ms/step ({cfg.model.W}x{cfg.model.H}) beside [trainer]'s "
          f"{trainer_ms:.3f} (bench scene, in process, this call); the CLI's own "
          f"{secs - wall:.3f} s of its {secs:.3f} (start, config, data, init, artifacts); "
          f"{GPU}")
    if overflow:
        raise AssertionError(f"[cli {tag}] bin overflow: {overflow}")
    if len(losses) != steps or not np.isfinite(losses).all() or (
            falling and not losses[-1] < losses[0]):
        raise AssertionError(f"[cli {tag}] loss trace {losses[:3]} ... {losses[-3:]}")
    if launches.get(fwd) != steps or launches.get(bwd) != steps:
        raise AssertionError(f"[cli {tag}] {launches} for {steps} steps")
    if cfg.output_dir != str(run) or cfg.model.urdf_path != "assets/mini_arm.urdf":
        raise AssertionError(f"[cli {tag}] config.yaml reads back as {cfg}")
    if limits and not (m["err_trans_geodesic_cm"] < limits[0]
                       and m["err_rot_geodesic_deg"] < limits[1]):
        raise AssertionError(f"[cli {tag}] ended at {m}")
    return cfg


def cli_phase(work: Path, trainer_ms: float):
    """[cli]: every command-line tool, started as a user starts it (``python
    -m easyhec_torch.cli.<name> -c configs/<file>.yaml ...``) in a fresh
    interpreter with cwd at the checkout, no ``--device`` flag, and PyYAML,
    JAX, optax, easyhec_tpu, OpenCV and matplotlib blocked; W = ``work``.

    1. configs/sim_mini.yaml exactly as the README runs it: ``simulate --out
       W/sim`` then ``run dataset.data_dir=W/sim`` (the dense fused route,
       K1f/K1b and K4f, at its 240x320 and 400 steps, from the dataset's GT).
    2. configs/xarm7_example.yaml at its widths (1280x720, 16x32 tiles, cap
       1664, rect 8x5, bin_big_k 3840, compact_chunks 384, adaptive
       rebinning, 1000 steps) with the arm swapped by CLI_X7's overrides:
       ``simulate --n-frames 10`` (its own camera: 1.6 m, 40 deg, 0.9 m, f =
       1.2 x 1280); ``run`` with the config's global_search init (no pose
       limit: on the mini arm the search may land on a rolled pose, and
       its refine parts from the JAX package's for the method's reasons,
       held by tests/test_torch_pose_init.py's
       test_global_search_bench_arm_matches_jax and
       test_refine_parting_is_explained); ``run``
       from the GT perturbed as cli/run.py::perturbed_start does, passed as
       a nested flow list with init_method=manual (1.5 cm, 1.5 deg);
       ``validate`` and ``tune_init --global-search`` on the first run;
       ``simulate --ring 8``; ``run --iterative`` from the perturbed GT
       (1.5 cm, 1.5 deg); ``train_segmenter``, ``annotate --auto`` on its
       camera 0 and ``diagnose`` on the masks annotate wrote.

    Cuts: the mini arm for the xArm7; ``run --iterative`` at 2 explore
    rounds (the config's 5); ``train_segmenter`` at 2 cameras x 4 frames and
    50 steps (6 x 8 and 600); ``diagnose --steps 100`` (the config's 1000).
    Every child must exit 0, print its line, launch its kernels and write its
    artifacts; none may rebuild a kernel library."""
    import numpy as np

    from easyhec_torch.cli.run import perturbed_start
    from easyhec_torch.ops import _build

    W = Path(work)
    W.mkdir(parents=True)
    sim, x7 = ["-c", "configs/sim_mini.yaml"], ["-c", "configs/xarm7_example.yaml"]
    t0 = time.perf_counter()
    secs = {}
    print(f"[cli] {len(CLI_BLOCKED)} packages blocked in every child: {', '.join(CLI_BLOCKED)}; "
          f"xarm7_example's overrides: {' '.join(CLI_X7)}; {GPU}")

    def cli(tag, module, args, expect, kernels, root=None, artifacts=()):
        launches, secs[tag] = _cli(tag, module, args, expect, kernels, root, artifacts)
        return launches, secs[tag]

    data = [f"{d}/{i:06d}.{e}" for d, e in (("color", "png"), ("mask", "png"), ("qpos", "txt"))
            for i in (0, 9)] + ["K.txt", "Tc_c2b.txt"]
    cli("simulate", "simulate", [*sim, "--out", f"{W}/sim"], "wrote 10 frames", {"sil_fwd"},
        W / "sim", data)
    la, s = cli("run", "run", [*sim, f"dataset.data_dir={W}/sim", f"output_dir={W}/simrun"],
                "solved Tc_c2b", {"loss_fwd", "loss_bwd", "sil_fwd", "tile_fwd"},
                W / "simrun", RUN_ARTIFACTS)
    _cli_run_held("run", W / "simrun", la, s, trainer_ms, "loss_fwd", "loss_bwd", (1.5, 1.5),
                  falling=False)  # sim_mini's auto init starts at the dataset's GT

    x7data = [f"dataset.data_dir={W}/x7"]
    cli("simulate x7", "simulate", [*x7, "--out", f"{W}/x7", "--n-frames", "10", *CLI_X7],
        "wrote 10 frames", {"sil_fwd"}, W / "x7", data)
    compact = {"loss_fwd_compact", "loss_bwd_compact", "sil_fwd"}
    la, s = cli("run x7 global_search", "run",
                [*x7, *CLI_X7, *x7data, f"output_dir={W}/x7run"], "solved Tc_c2b",
                compact | {"tile_fwd", "tile_bwd_counted"}, W / "x7run", RUN_ARTIFACTS)
    _cli_run_held("run x7 global_search", W / "x7run", la, s, trainer_ms,
                  "loss_fwd_compact", "loss_bwd_compact")
    start = perturbed_start(np.loadtxt(W / "x7" / "Tc_c2b.txt"), 0)
    # fixed-point digits: a float written as 1e-05 would read back as a
    # string (a YAML 1.1 float needs a dot), as it does under PyYAML
    flow = "[" + ", ".join("[" + ", ".join(f"{v:.9f}" for v in row) + "]" for row in start) + "]"
    la, s = cli("run x7 manual", "run",
                [*x7, *CLI_X7, *x7data, f"output_dir={W}/x7manual",
                 f"model.init_Tc_c2b={flow}", "model.init_method=manual"],
                "solved Tc_c2b", compact | {"tile_fwd"}, W / "x7manual", RUN_ARTIFACTS)
    cfg = _cli_run_held("run x7 manual", W / "x7manual", la, s, trainer_ms,
                        "loss_fwd_compact", "loss_bwd_compact", (1.5, 1.5))
    if not np.allclose(cfg.model.init_Tc_c2b, start, atol=1e-8):
        raise AssertionError(f"[cli run x7 manual] ran from {cfg.model.init_Tc_c2b}")
    run7 = [*CLI_X7, *x7data, f"output_dir={W}/x7run"]
    cli("validate", "validate", [*x7, *run7], '"mean_iou"', {"sil_fwd"}, W / "x7run",
        ["validate/report.json", "validate/overlay_0009.png"])
    cli("tune_init", "tune_init", [*x7, "--global-search", *run7], '"search_iou"',
        {"tile_fwd", "tile_bwd_counted", "sil_fwd"}, W / "x7run", ["tune_init/tune_overlay.png"])
    ring = [f"{d}/{i:06d}.{e}" for d, e in (("color", "png"), ("mask", "png"), ("pose", "txt"))
            for i in (0, 7)] + ["K.txt", "diameter.txt", "model.ply", "qpos.txt"]
    cli("simulate ring", "simulate", [*x7, "--out", f"{W}/ring", "--ring", "8", *CLI_X7],
        "wrote 8 ring views", {"sil_fwd"}, W / "ring", ring)
    cli("run --iterative", "run",
        [*x7, "--iterative", *CLI_X7, *x7data, f"output_dir={W}/x7it", "model.init_method=auto",
         "solver.explore_iters=2"], "simulated closed loop against GT", compact,
        W / "x7it", ["Tc_c2b.txt", "metrics.json", "checkpoints/round_000.npz",
                     "checkpoints/round_001.npz", "captures/mask/000001.png"])
    m = json.loads((W / "x7it" / "metrics.json").read_text())
    print(f"[cli run --iterative] error {m['err_trans_geodesic_cm']:.4f} cm "
          f"{m['err_rot_geodesic_deg']:.4f} deg (limits 1.5 cm, 1.5 deg)")
    if not (m["err_trans_geodesic_cm"] < 1.5 and m["err_rot_geodesic_deg"] < 1.5):
        raise AssertionError(f"[cli run --iterative] ended at {m}")
    cli("train_segmenter", "train_segmenter",
        [*x7, "--out", f"{W}/seg.pkl", "--data-out", f"{W}/segdata", "--n-cams", "2",
         "--frames-per-cam", "4", "--steps", "50", *CLI_X7, f"output_dir={W}/segrun"],
        '"val_iou_mean"', {"sil_fwd"}, W, ["seg.pkl", "segdata/cam00/mask/000003.png",
                                           "segdata/cam01/K.txt"])
    cli("annotate", "annotate",
        ["--data-dir", f"{W}/segdata/cam00", "--auto", "--weights", f"{W}/seg.pkl",
         "--overwrite"], "wrote 4 masks", set(), W / "segdata" / "cam00",
        ["mask/000000.png", "mask/000003.png"])
    cli("diagnose", "diagnose",
        [*x7, "--out", f"{W}/diag", "--steps", "100", *CLI_X7,
         f"dataset.data_dir={W}/segdata/cam00", f"output_dir={W}/diagrun"],
        "report written to", compact, W / "diag", ["report.json", "report.md", "overlays.png"])
    total = time.perf_counter() - t0
    libs = len(list(_build._build_dir().glob("*.so")))
    print(f"[cli] {len(secs)} commands in {total:.3f} s: "
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}; every child loaded "
          f"the {libs} kernel libraries built above, none rebuilt (no child [build]); {GPU}")
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="replay the compact, dense and unfused calibrate runs under "
                         "torch.profiler and write their summaries into DIR")
    ap.add_argument("--parallel-worker", nargs=3, metavar=("RANK", "RDV", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of [parallel 2x2]
    args = ap.parse_args()
    if args.parallel_worker:
        rank, rdv, work_dir = args.parallel_worker
        return parallel_worker(int(rank), rdv, Path(work_dir))

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

    t0 = t_start = time.perf_counter()
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
    for k in ("bin_count", "tri_setup", "compact_pack", *_step_kernels()):
        launches[f"{k} calib"] = launches.pop(k)
        unf_launches.pop(k)
    if unf_launches != {"tile_fwd": args.steps, "tile_bwd_counted": args.steps}:
        raise AssertionError(f"K5 launches {unf_launches}: not one K5f and one K5b per step")
    launches.update(unf_launches)
    print(f"[main] dense and unfused against compact, same call: {ms_d:.3f} and {ms_u:.3f} "
          f"against {ms_c:.3f} ms/step ({ms_d / ms_c:.3f}x, {ms_u / ms_c:.3f}x)")
    main_eager_phase(lp, K, xi, args.steps, [
        ("compact", renderer, target, compact_k),
        ("dense", dense, target_d, {"loss_fwd": pr.loss_fwd_cuda,
                                    "loss_bwd": pr.loss_bwd_cuda})])
    behaviour_phase([
        ("compact", renderer, target, prc.loss_fwd_compact_cuda, prc.loss_bwd_compact_cuda),
        ("dense", dense, target_d, pr.loss_fwd_cuda, pr.loss_bwd_cuda),
        ("unfused", unfused, target_u, tr.tile_fwd_cuda, tr.tile_bwd_counted_cuda)],
        lp, K, xi, args.steps)
    profile_s = 0.0
    if args.profile:
        t0 = time.perf_counter()
        d0 = (xi + 0.01).cpu().numpy()
        _profile(renderer, lp, K, d0, target, args.steps, rebins_c, Path(args.profile),
                 "compact", "loss_fwd_compact_kernel", "loss_bwd_compact_kernel")
        _profile(dense, lp, K, d0, target_d, args.steps, rebins_d, Path(args.profile),
                 "dense", "pose_fwd_kernel<true>", "pose_bwd_kernel<true>")
        _profile(unfused, lp, K, d0, target_u, args.steps, rebins_u, Path(args.profile),
                 "unfused", "tile_fwd_kernel", "tile_bwd_kernel")
        profile_s = time.perf_counter() - t0
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    trainer_launches, trainer_ms, trainer_cfg, trainer_batch = trainer_phase(
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
    kernels += binner_phase(renderer, lp, K, xi, explore_in)
    kernels += rebin_phase(renderer, lp, K, xi, explore_in)
    kernels += step_phase()
    launches["compact_tile_acc"] = iter_launches["K3"]
    for k in ("bin_count", "tri_setup", "compact_pack"):
        launches[f"{k} explore"] = iter_launches[f"{k} explore"]
    schedules_phase(renderer, lp, K, xi, target, args.steps)
    optimizer_groups_phase()
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
    watch_phase(trainer_cfg.output_dir, args.steps, trainer_cfg.solver.log_interval)
    nccl_launches = parallel_nccl_phase(renderer, lp, K, xi, target, args.steps)
    for k in _step_kernels():
        launches[f"{k} rig"] = nccl_launches[k]
    (work / "parallel").mkdir()
    band_rows, band_launches = parallel_2x2_phase(C5_STEPS, work / "parallel")
    kernels += band_rows
    for row, n in zip(band_rows, band_launches.values()):
        launches[row["name"]] = n
    torch.cuda.empty_cache()  # the children share the card with this process
    cli_phase(work / "cli", trainer_ms)
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

    print(f"[smoke] {time.perf_counter() - t_start:.1f} s in all, {profile_s:.1f} of them "
          f"in --profile's replays")
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
