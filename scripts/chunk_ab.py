#!/usr/bin/env python3
"""Time the calibration paths on two trees of this repository, in turns, on
one GPU: the A/B measurement for a change to the optimizer loop.

    python3 scripts/chunk_ab.py --trees A_DIR B_DIR [--turns 3] [--out DIR]

A_DIR and B_DIR are checkouts (for example ``git archive`` of two commits
unpacked into a directory that .gitignore lists). Turn i runs A then B, or
B then A on odd turns (A B B A A B ...), each as a child process that
imports that tree's ``chip_smoke.py`` and ``easyhec_torch``, builds its
kernels and its bench scene, and runs its phases: ``calibrate`` for 1000
steps on the compact, dense and unfused routes (``main_path``), ``[parallel
nccl]`` (calibrate and sharded_calibrate on one NCCL rank) and
``[iterative]`` (five rounds of the online loop). The child times the entry
points itself, through wrappers it sets on the modules the phases import
them from, so it reads no printed line: ``sharded_calibrate``'s first call
in ``[parallel nccl]`` (the tree's main path; a later call is its eager
comparison), that phase's ``calibrate``, ``run_iterative`` and the
``calibrate`` calls inside it. It prints, per tree, the median and the
range of each figure over the turns, with the card's name and power limit,
and writes every child's log and numbers into DIR (default runs/chunk_ab,
which .gitignore lists).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

STEPS = 1000


def _timed(holder, name: str, calls: list):
    """Wrap holder.name so that each call appends its seconds (the card
    synchronized before and after) to ``calls``. -> a function that puts
    the original back."""
    import torch

    real = getattr(holder, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)

    setattr(holder, name, wrapper)
    return lambda: setattr(holder, name, real)


def child(tree: Path) -> dict:
    """The phases of one tree, in this process -> {figure: value}."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from easyhec_torch.geometry import se3
    from easyhec_torch.ops import _build
    from easyhec_torch.ops import pose_raster as pr
    from easyhec_torch.ops import pose_raster_compact as prc
    from easyhec_torch.ops import tile_raster as tr
    from easyhec_torch.render import RobotRenderer
    from easyhec_torch.render.fused import silhouette_compact

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement needs the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cs.GPU = cs._gpu_line()
    renderer, lp, K, xi, _ = cs.build_scene(cs.DEVICE)
    Tc = se3.exp(xi)
    target = (silhouette_compact(renderer, Tc, K, renderer.bin_state(Tc, lp, K)) > 0.5).float()
    dense = RobotRenderer(renderer.meshes, cs.H, cs.W, device=cs.DEVICE,
                          tile=renderer.tile._replace(compact_chunks=0))
    unfused = RobotRenderer(renderer.meshes, cs.H, cs.W, device=cs.DEVICE,
                            tile=renderer.tile._replace(fused=False, compact_chunks=0))
    with torch.no_grad():
        target_d = (dense.silhouette(Tc, lp, K) > 0.5).float()
        target_u = (unfused.silhouette(Tc, lp, K) > 0.5).float()
    out = {"gpu": cs.GPU, "torch": torch.__version__, "cuda": torch.version.cuda}
    for name, r, t, kern in (
            ("compact", renderer, target, {"f": prc.loss_fwd_compact_cuda,
                                           "b": prc.loss_bwd_compact_cuda}),
            ("dense", dense, target_d, {"f": pr.loss_fwd_cuda, "b": pr.loss_bwd_cuda}),
            ("unfused", unfused, target_u, {"f": tr.tile_fwd_cuda,
                                            "b": tr.tile_bwd_counted_cuda})):
        _, out[f"{name}_ms"], out[f"{name}_rebins"] = cs.main_path(
            r, lp, K, xi, t, STEPS, kern, f"main {name}")
    import easyhec_torch.models.calib as calib
    import easyhec_torch.trainer.iterative as itr
    import easyhec_torch.parallel as par

    sharded, calibrate, loop, loop_calibrate = [], [], [], []
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        with contextlib.ExitStack() as undo:
            undo.callback(_timed(par, "sharded_calibrate", sharded))
            undo.callback(_timed(calib, "calibrate", calibrate))
            cs.parallel_nccl_phase(renderer, lp, K, xi, target, STEPS)
        with contextlib.ExitStack() as undo:
            undo.callback(_timed(itr, "run_iterative", loop))
            undo.callback(_timed(itr, "calibrate", loop_calibrate))
            cs.iterative_phase(STEPS)
    print(log.getvalue(), end="")
    out["parallel_nccl_sharded_ms"] = sharded[0] / STEPS * 1e3
    out["parallel_nccl_calibrate_ms"] = calibrate[0] / STEPS * 1e3
    out["iterative_s"], out["iterative_calibrate_s"] = loop[0], sum(loop_calibrate)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default="runs/chunk_ab")
    ap.add_argument("--child", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        res = child(Path(args.child).resolve())
        print("CHUNK_AB " + json.dumps(res))
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = [Path(t).resolve() for t in args.trees]
    runs = {"A": [], "B": []}
    for turn in range(args.turns):
        order = ("A", "B") if turn % 2 == 0 else ("B", "A")
        for tag in order:
            tree = trees[0] if tag == "A" else trees[1]
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                str(tree)], cwd=tree, capture_output=True, text=True)
            (out / f"turn{turn}_{tag}.log").write_text(p.stdout + p.stderr)
            if p.returncode != 0:
                print(p.stdout[-3000:] + p.stderr[-3000:])
                raise SystemExit(f"turn {turn} tree {tag} failed: rc {p.returncode}")
            res = json.loads(p.stdout.rsplit("CHUNK_AB ", 1)[1].splitlines()[0])
            runs[tag].append(res)
            print(f"[chunk_ab] turn {turn} {tag} ({tree.name}), {time.perf_counter() - t0:.1f} "
                  f"s: " + json.dumps(res))
    keys = [k for k in runs["A"][0] if isinstance(runs["A"][0][k], float)]
    summary = {}
    for tag, tree in zip("AB", trees):
        summary[tag] = {"tree": str(tree)}
        for k in keys:
            xs = [r[k] for r in runs[tag]]
            summary[tag][k] = dict(median=statistics.median(xs), min=min(xs), max=max(xs),
                                   runs=xs)
            print(f"[chunk_ab] {tag} {k}: median {statistics.median(xs)} ({min(xs)}-"
                  f"{max(xs)}) over {len(xs)} turns")
    summary["gpu"] = runs["A"][0]["gpu"]
    (out / "ab.json").write_text(json.dumps({"summary": summary, "runs": runs}, indent=1))
    print(f"[chunk_ab] {summary['gpu']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
