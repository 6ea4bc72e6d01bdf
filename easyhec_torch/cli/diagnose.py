"""Dataset/fit diagnostic tool: "why doesn't this capture set fit?"

Counterpart of easyhec_tpu/cli/diagnose.py. Usage:

    python -m easyhec_torch.cli.diagnose -c configs/sim_mini.yaml --out DIR \
        [--downscale 2] [--steps N] [--loo] [--multistart 4] [--robust 0.3] \
        [--repair [--repair-exclude-iou 0.5]] [--device cuda|cpu] [model.H=120 ...]

Per-frame IoU under the best joint pose (a baseline ``calibrate``), a robust
re-fit, the cross-pair matrix (does mask_i match a DIFFERENT frame's qpos
better than its own?), a render-free image-space pairing check, optional
pairing repair (Hungarian assignment on the cross-pair IoU, refit, then
exclude the frames no qpos explains and refit), leave-one-out held-out IoU
and multistart. Fits run through the port's ``calibrate`` (the fused loss
kernels on the card) with on_overflow="warn"; renders through
``RobotRenderer.silhouette`` (K4f on the fused routes).

Writes <out>/report.json, <out>/report.md and <out>/overlays.png (mask in
red, render in green, one panel per frame, drawn with utils.imaging's
image_grid and written by write_png, so no plotting package is needed).
The run goes on CUDA unless ``--device cpu`` is given; ``diagnose(cfg, out,
batch=...)`` takes an in-memory Config and CalibBatch.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..geometry import se3
from ..models.calib import calibrate, downscale_K, downscale_mask
from ..utils.imaging import image_grid, write_png


def _iou(a: np.ndarray, b: np.ndarray, thr: float = 0.5) -> float:
    A, B = a > thr, b > thr
    inter = float(np.logical_and(A, B).sum())
    union = float(np.logical_or(A, B).sum())
    return inter / union if union else 1.0


def _fit(rt, cfg, lp, K, masks, init_dof, steps=None, robust=0.0):
    # on_overflow="warn": diagnostics run on known-bad datasets whose fits
    # wander far from any audited pose; an overflow degrades the renders but
    # the analysis must complete (the warning is logged).
    return calibrate(
        init_dof, rt.renderer, lp, K, masks,
        num_steps=steps or cfg.solver.num_epochs,
        max_lr=cfg.solver.max_lr,
        optimizer=cfg.solver.optimizer,
        scheduler=cfg.solver.scheduler,
        grad_clip=cfg.solver.grad_clip,
        sharpness=cfg.render.sharpness,
        robust_delta=robust,
        rebin_every=cfg.solver.rebin_every,
        on_overflow="warn",
    )


def _renders(rt, dof, lp, K):
    dev = rt.renderer.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    with torch.no_grad():
        return rt.renderer.silhouette(se3.exp(t(dof)), t(lp), t(K)).cpu().numpy()


def diagnose(cfg, out, batch=None, downscale: int = 1, steps: int = 0, loo: bool = False,
             multistart: int = 0, robust: float = 0.3, repair: bool = False,
             repair_exclude_iou: float = 0.5, device=None) -> dict:
    """Run the diagnostics over ``batch`` (or cfg.dataset.data_dir) on
    ``device`` (None = CUDA) and write the artifacts under ``out``. Returns
    the report (report.json's content)."""
    from ..data.dataset import load_calib_dataset
    from ..trainer.offline import _init_dof, build_runtime

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    s = max(1, downscale)
    if s > 1:
        cfg.model.H //= s
        cfg.model.W //= s
    rt = build_runtime(cfg, device)
    if batch is None:
        batch = load_calib_dataset(cfg.dataset.data_dir, rt.chain, rt.link_names)
    masks = downscale_mask(batch.masks, s)
    K = downscale_K(batch.K, s)
    lp = batch.link_poses.astype(np.float32)
    B = masks.shape[0]
    init = _init_dof(cfg, batch, rt)
    steps = steps or None

    report: dict = {"n_frames": B, "downscale": s,
                    "H": cfg.model.H, "W": cfg.model.W}

    # ---- 1. baseline joint fit -------------------------------------------
    t0 = time.time()
    base = _fit(rt, cfg, lp, K, masks, init, steps=steps)
    sil = _renders(rt, base.dof, lp, K)
    per_frame_iou = [_iou(sil[i], masks[i]) for i in range(B)]
    report["baseline"] = {
        "loss_first": float(base.losses[0]),
        "loss_last": float(base.losses[-1]),
        "mean_iou": float(np.mean(per_frame_iou)),
        "per_frame_iou": [round(v, 4) for v in per_frame_iou],
        "dof": base.dof.tolist(),
        "wall_s": round(time.time() - t0, 1),
    }
    print(f"baseline: loss {base.losses[0]:.0f}->{base.losses[-1]:.0f}, "
          f"mIoU {np.mean(per_frame_iou):.3f}")

    # ---- 2. robust re-fit -------------------------------------------------
    if robust > 0:
        rob = _fit(rt, cfg, lp, K, masks, init, steps=steps, robust=robust)
        sil_r = _renders(rt, rob.dof, lp, K)
        iou_r = [_iou(sil_r[i], masks[i]) for i in range(B)]
        report["robust"] = {
            "delta": robust,
            "loss_last": float(rob.losses[-1]),
            "mean_iou": float(np.mean(iou_r)),
            "per_frame_iou": [round(v, 4) for v in iou_r],
            "dof": rob.dof.tolist(),
        }
        print(f"robust(delta={robust}): mIoU {np.mean(iou_r):.3f}")

    # ---- 3. cross-pair matrix --------------------------------------------
    # IoU of mask_i against the render of frame j's qpos under the BASELINE
    # pose: off-diagonal maxima mean mask_i matches another frame's joint
    # configuration better than its own — a capture-time pairing defect no
    # rigid pose can fix.
    cross = np.zeros((B, B), np.float32)
    for i in range(B):
        for j in range(B):
            cross[i, j] = _iou(masks[i], sil[j])
    best_j = cross.argmax(axis=1)
    report["cross_pair"] = {
        "matrix": np.round(cross, 3).tolist(),
        "best_match": best_j.tolist(),
        "mismatched_frames": [int(i) for i in range(B) if best_j[i] != i],
    }
    print("cross-pair best match per mask:", best_j.tolist())

    # ---- 3a. RENDER-FREE image-space pairing check ------------------------
    # Does mask_i actually outline the arm VISIBLE in color_i? Scored with
    # no renderer, FK or projection involved: the mean image-gradient
    # magnitude along mask_j's boundary in color_i (normalized by the
    # image's mean gradient). A correctly paired mask hugs real object
    # contours, so the matrix is diagonal-dominant iff color<->mask pairing
    # is consistent — discriminating "qpos files scrambled" from "our
    # FK/projection is biased" independently of our render path.
    if batch.rgb.any():
        img_cross = _image_pair_matrix(batch.rgb, batch.masks)
        ibest = img_cross.argmax(axis=1)
        diag = np.diag(img_cross)
        off = img_cross[~np.eye(B, dtype=bool)]
        report["image_pairing"] = {
            "metric": "mean boundary gradient / mean image gradient",
            "matrix": np.round(img_cross, 2).tolist(),
            "best_mask_per_color": ibest.tolist(),
            "diag_mean": round(float(diag.mean()), 3),
            "offdiag_mean": round(float(off.mean()), 3),
            "color_mask_pairing_consistent": bool((ibest == np.arange(B)).all()),
        }
        print(
            f"image-space pairing: best mask per color {ibest.tolist()} "
            f"(diag {diag.mean():.2f} vs off-diag {off.mean():.2f})"
        )

    # ---- 3b. pairing repair ----------------------------------------------
    if repair:
        perm = _optimal_assignment(cross)
        rep = _fit(rt, cfg, lp[perm], K, masks, base.dof, steps=steps)
        sil_p = _renders(rt, rep.dof, lp[perm], K)
        iou_p = [_iou(sil_p[i], masks[i]) for i in range(B)]
        report["repair"] = {
            "assignment_mask_to_qpos": perm.tolist(),
            "n_reassigned": int((perm != np.arange(B)).sum()),
            "loss_last": float(rep.losses[-1]),
            "mean_iou": float(np.mean(iou_p)),
            "per_frame_iou": [round(v, 4) for v in iou_p],
            "dof": rep.dof.tolist(),
        }
        print(f"repair: assignment {perm.tolist()}, "
              f"mIoU {np.mean(iou_p):.3f}")

        # Exclude-and-refit tail: the Hungarian assignment must place EVERY
        # mask somewhere, so a mask whose true qpos was never recorded gets
        # a leftover qpos and drags the pose (r3: frame 8 at IoU 0.34
        # post-repair). Reject frames the optimal pairing still cannot
        # explain, refit on the consistent remainder, and report each
        # rejected mask's best IoU against ANY qpos under the final pose —
        # ~equal to its assigned IoU means no qpos in the set explains it.
        thr = repair_exclude_iou
        bad = [i for i in range(B) if iou_p[i] < thr]
        if thr > 0 and bad and len(bad) <= B - 3:
            keep = [i for i in range(B) if i not in bad]
            lp_rep = lp[perm]
            rep2 = _fit(rt, cfg, lp_rep[keep], K, masks[keep], rep.dof,
                        steps=steps)
            sil_k = _renders(rt, rep2.dof, lp_rep[keep], K)
            iou_k = {k: _iou(sil_k[t], masks[k])
                     for t, k in enumerate(keep)}
            sil_all = _renders(rt, rep2.dof, lp, K)
            resid = {
                i: {
                    "assigned_iou": round(float(iou_p[i]), 4),
                    "best_iou_any_qpos": round(
                        max(_iou(masks[i], sil_all[j]) for j in range(B)), 4
                    ),
                    "best_qpos": int(np.argmax(
                        [_iou(masks[i], sil_all[j]) for j in range(B)]
                    )),
                }
                for i in bad
            }
            report["repair_exclude"] = {
                "threshold": thr,
                "excluded_frames": bad,
                "kept_frames": keep,
                "mean_iou_kept": float(np.mean(list(iou_k.values()))),
                "per_frame_iou_kept": {
                    str(k): round(v, 4) for k, v in iou_k.items()
                },
                "excluded_residuals": resid,
                "dof": rep2.dof.tolist(),
            }
            print(
                f"repair-exclude: dropped {bad}, mIoU(kept) "
                f"{np.mean(list(iou_k.values())):.3f}; residuals "
                + ", ".join(
                    f"{i}: best any-qpos {v['best_iou_any_qpos']}"
                    for i, v in resid.items()
                )
            )

    # ---- 4. leave-one-out consistency ------------------------------------
    if loo:
        loo = []
        for i in range(B):
            keep = [j for j in range(B) if j != i]
            fit_i = _fit(rt, cfg, lp[keep], K, masks[keep], base.dof,
                         steps=(steps or cfg.solver.num_epochs) // 2)
            sil_i = _renders(rt, fit_i.dof, lp[i:i + 1], K)[0]
            held = _iou(sil_i, masks[i])
            in_set = float(np.mean([
                _iou(r, m) for r, m in zip(
                    _renders(rt, fit_i.dof, lp[keep], K), masks[keep]
                )
            ]))
            loo.append({"frame": i, "held_out_iou": round(held, 4),
                        "in_set_mean_iou": round(in_set, 4),
                        "dof": fit_i.dof.tolist()})
            print(f"LOO frame {i}: held-out IoU {held:.3f} "
                  f"(in-set mean {in_set:.3f})")
        report["leave_one_out"] = loo

    # ---- 5. multistart ----------------------------------------------------
    if multistart > 0:
        rng = np.random.default_rng(0)
        runs = []
        for k in range(multistart):
            pert = init + rng.normal(0, 0.02, 6).astype(np.float32)
            fit_k = _fit(rt, cfg, lp, K, masks, pert, steps=steps)
            runs.append({"loss_last": float(fit_k.losses[-1]),
                         "dof": fit_k.dof.tolist()})
            print(f"multistart {k}: loss {fit_k.losses[-1]:.0f}")
        dofs = np.asarray([r["dof"] for r in runs])
        report["multistart"] = {
            "runs": runs,
            "dof_spread": np.ptp(dofs, axis=0).tolist(),
        }

    # ---- artifacts --------------------------------------------------------
    (out / "report.json").write_text(json.dumps(report, indent=2))
    _write_markdown(out / "report.md", report)
    _overlay_panel(out / "overlays.png", masks, sil)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="calibration dataset diagnostics")
    ap.add_argument("-c", "--config-file", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--downscale", type=int, default=1,
                    help="run all fits at 1/N resolution (N× faster)")
    ap.add_argument("--steps", type=int, default=0,
                    help="override steps per fit (0 = cfg.solver.num_epochs)")
    ap.add_argument("--loo", action="store_true",
                    help="leave-one-out per-frame consistency fits")
    ap.add_argument("--multistart", type=int, default=0,
                    help="N perturbed-init fits (basin check)")
    ap.add_argument("--robust", type=float, default=0.3,
                    help="robust_delta for the robust re-fit (0 disables)")
    ap.add_argument("--repair", action="store_true",
                    help="optimal mask<->qpos re-assignment (Hungarian on "
                    "the cross-pair IoU matrix) + refit: if the re-paired "
                    "fit's mIoU jumps, the dataset's pairing is proven "
                    "scrambled (no rigid pose can explain it)")
    ap.add_argument("--repair-exclude-iou", type=float, default=0.5,
                    help="after the repair fit, frames below this IoU are "
                    "rejected (their mask has no matching qpos in the set) "
                    "and the pose refit on the consistent remainder; 0 "
                    "disables the exclude-and-refit tail")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    from ..config import load_config

    cfg = load_config(args.config_file, args.opts)
    diagnose(cfg, args.out, downscale=args.downscale, steps=args.steps, loo=args.loo,
             multistart=args.multistart, robust=args.robust, repair=args.repair,
             repair_exclude_iou=args.repair_exclude_iou, device=args.device)
    print("report written to", args.out)
    return 0


def _image_pair_matrix(rgb: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """[B, B] render-free pairing scores: rows = color images, cols = masks.

    score(i, j) = mean gradient magnitude of color_i along the boundary of
    mask_j, normalized by color_i's mean gradient. >1 means the boundary
    lands on stronger-than-average image edges; the paired mask should
    dominate its row. Uses only numpy image ops — no FK, projection or
    rendering (the point: an independent check of the capture pairing).
    """
    B = masks.shape[0]
    grads, bounds = [], []
    for i in range(B):
        g = rgb[i].astype(np.float32).mean(-1) / 255.0
        gx = np.abs(np.diff(g, axis=1, prepend=g[:, :1]))
        gy = np.abs(np.diff(g, axis=0, prepend=g[:1]))
        grads.append(gx + gy)
        m = masks[i] > 0.5
        er = m.copy()
        er[1:] &= m[:-1]; er[:-1] &= m[1:]
        er[:, 1:] &= m[:, :-1]; er[:, :-1] &= m[:, 1:]
        dl = m.copy()
        dl[1:] |= m[:-1]; dl[:-1] |= m[1:]
        dl[:, 1:] |= m[:, :-1]; dl[:, :-1] |= m[:, 1:]
        bounds.append(dl & ~er)
    out = np.zeros((B, B), np.float32)
    for i in range(B):
        gm = grads[i]
        mean = max(float(gm.mean()), 1e-9)
        for j in range(B):
            bb = bounds[j]
            out[i, j] = float(gm[bb].mean()) / mean if bb.any() else 0.0
    return out


def _optimal_assignment(cross: np.ndarray) -> np.ndarray:
    """perm with perm[i] = qpos index assigned to mask i, maximizing total
    IoU (Hungarian; greedy fallback if scipy is unavailable)."""
    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:
        B = cross.shape[0]
        perm = np.full(B, -1, np.int64)
        taken = set()
        for _ in range(B):
            best, bi, bj = -1.0, -1, -1
            for i in range(B):
                if perm[i] >= 0:
                    continue
                for j in range(B):
                    if j in taken:
                        continue
                    if cross[i, j] > best:
                        best, bi, bj = cross[i, j], i, j
            perm[bi] = bj
            taken.add(bj)
        return perm
    rows, cols = linear_sum_assignment(-cross)
    perm = np.empty(cross.shape[0], np.int64)
    perm[rows] = cols
    return perm


def _write_markdown(path: Path, r: dict) -> None:
    lines = [
        "# Calibration dataset diagnostic report", "",
        f"{r['n_frames']} frames at {r['W']}x{r['H']} "
        f"(downscale {r['downscale']}).", "",
        "## Baseline joint fit",
        f"- loss {r['baseline']['loss_first']:.0f} -> "
        f"{r['baseline']['loss_last']:.0f}",
        f"- mean IoU **{r['baseline']['mean_iou']:.3f}**",
        "- per-frame IoU: " + ", ".join(
            f"{i}:{v:.2f}" for i, v in enumerate(r["baseline"]["per_frame_iou"])
        ), "",
    ]
    if "robust" in r:
        lines += [
            "## Robust re-fit",
            f"- delta {r['robust']['delta']}, mean IoU "
            f"**{r['robust']['mean_iou']:.3f}**",
            "- per-frame IoU: " + ", ".join(
                f"{i}:{v:.2f}" for i, v in enumerate(r["robust"]["per_frame_iou"])
            ), "",
        ]
    if "image_pairing" in r:
        ip = r["image_pairing"]
        verdict = (
            "color<->mask pairing CONSISTENT (the scrambled axis is the "
            "qpos files)" if ip["color_mask_pairing_consistent"]
            else "color<->mask pairing inconsistent"
        )
        lines += [
            "## Render-free image-space pairing check",
            "Mean image-gradient magnitude of color_i along the boundary of "
            "mask_j, normalized (no renderer/FK/projection involved).",
            f"- best mask per color: {ip['best_mask_per_color']}",
            f"- diagonal mean {ip['diag_mean']} vs off-diagonal mean "
            f"{ip['offdiag_mean']}",
            f"- **{verdict}**", "",
        ]
    cp = r["cross_pair"]
    lines += [
        "## Cross-pair analysis",
        "mask_i vs render(qpos_j) IoU; a mask whose best match is another "
        "frame's qpos indicates capture-time pairing noise.",
        f"- best match per mask: {cp['best_match']}",
        f"- mismatched frames: **{cp['mismatched_frames']}**", "",
    ]
    if "repair" in r:
        rp = r["repair"]
        lines += [
            "## Pairing repair (optimal re-assignment + refit)",
            f"- assignment mask->qpos: {rp['assignment_mask_to_qpos']}",
            f"- frames reassigned: {rp['n_reassigned']}",
            f"- mean IoU after repair: **{rp['mean_iou']:.3f}** "
            f"(vs {r['baseline']['mean_iou']:.3f} as-shipped)",
            "- per-frame IoU: " + ", ".join(
                f"{i}:{v:.2f}" for i, v in enumerate(rp["per_frame_iou"])
            ), "",
        ]
    if "repair_exclude" in r:
        re_ = r["repair_exclude"]
        lines += [
            "## Exclude-and-refit tail (assignment with rejection)",
            f"- frames rejected (post-repair IoU < {re_['threshold']}): "
            f"**{re_['excluded_frames']}**",
            f"- mean IoU over the kept {len(re_['kept_frames'])} frames: "
            f"**{re_['mean_iou_kept']:.3f}**",
            "- kept per-frame IoU: " + ", ".join(
                f"{k}:{v:.2f}" for k, v in re_["per_frame_iou_kept"].items()
            ),
            "- rejected-mask residuals (best IoU against ANY qpos under the "
            "final pose — ~assigned IoU means NO recorded qpos explains the "
            "mask):",
        ] + [
            f"    - frame {i}: assigned {v['assigned_iou']}, best any-qpos "
            f"{v['best_iou_any_qpos']} (qpos {v['best_qpos']})"
            for i, v in re_["excluded_residuals"].items()
        ] + [""]
    if "leave_one_out" in r:
        lines += ["## Leave-one-out consistency",
                  "| frame | held-out IoU | in-set mean IoU |",
                  "|---|---|---|"]
        for e in r["leave_one_out"]:
            lines.append(
                f"| {e['frame']} | {e['held_out_iou']:.3f} | "
                f"{e['in_set_mean_iou']:.3f} |"
            )
        lines.append("")
    if "multistart" in r:
        lines += [
            "## Multistart",
            f"- final losses: "
            + ", ".join(f"{x['loss_last']:.0f}" for x in r["multistart"]["runs"]),
            f"- dof spread (ptp): "
            + ", ".join(f"{v:.4f}" for v in r["multistart"]["dof_spread"]),
            "",
        ]
    path.write_text("\n".join(lines))


def _overlay_panel(path: Path, masks: np.ndarray, sil: np.ndarray) -> None:
    """One panel per frame, mask in red and render in green, five to a row."""
    panels = [np.clip(np.stack([m, r, np.zeros_like(m)], axis=-1), 0, 1)
              for m, r in zip(masks, sil)]
    write_png(path, image_grid(panels, cols=min(len(panels), 5)))


if __name__ == "__main__":
    raise SystemExit(main())
