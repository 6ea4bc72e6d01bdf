"""Bin-load audit of a rig cell (traffic ``sharded``): for each rank's
share of the mesh (its data shard of frame-views, its band of rows), at
the ground truth and at every start of the cell's bank, the largest tile
load, the most triangles outside the binner's 2x1-tile span class, the
widest tile span and the most compact chunks of 128 slots a frame, counted
from the reference's projection of the margin-dilated bboxes of the valid,
front-facing, on-screen triangles (as the counting binner counts them);
then the budgets that chip_smoke.py::config5_tile (:3759) sets from such an
audit (cap and big_k 1.3x, rounded up to 128 and 256; rect 2 rows and 1
column over the widest span; chunks 1.3x, at least 400). With --device,
the program's binner then builds every audited share's bin state at the
configuration's budgets, which must not overflow.

    python hec_bench/audit_rig.py --workload c5-rig-1080p.calib-4card [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hec_bench import harness as hb  # noqa: E402
from hec_bench import rig, scene  # noqa: E402
from hec_bench.reference import geometry as geo  # noqa: E402
from hec_bench.reference.render import Scene, project  # noqa: E402


def shares(cfg: dict) -> list[tuple[slice, int]]:
    """(frame slice, first row) of each rank of the mesh, in rank order."""
    nd, nt = cfg["mesh"]["data"], cfg["mesh"]["tile"]
    B = cfg["rig"]["views"] * cfg["rig"]["frames"]
    bh = cfg["H"] // nt
    return [(slice(d * B // nd, (d + 1) * B // nd), t * bh) for d in range(nd) for t in range(nt)]


def loads(cfg: dict, a: scene.Arm, Tc: np.ndarray, lp: np.ndarray, y0: int) -> dict:
    """The load figures of frames lp under Tc on the band of rows [y0, y0 +
    H / n_tile)."""
    r = cfg["render"]
    th, tw, m = r["tile_h"], r["tile_w"], float(r["margin"])
    h, W = cfg["H"] // cfg["mesh"]["tile"], cfg["W"]
    K = geo.intrinsics(cfg["H"], W, cfg["f"]).astype(np.float64)
    K[1, 2] -= y0
    c, ids = a.corners()
    sc = Scene(c, ids, h, W, K, cull=r["cull_backfaces"], sharpness=r["sharpness"])
    u, v, valid = project(sc, torch.as_tensor(Tc), torch.as_tensor(lp))
    lox, hix = u.amin(-1) - m, u.amax(-1) + m
    loy, hiy = v.amin(-1) - m, v.amax(-1) + m
    n_ty, n_tx = -(-h // th), -(-W // tw)
    use = valid & (hix > 0) & (lox < W) & (hiy > 0) & (loy < h)
    ty0 = torch.clamp(torch.floor(loy / th).long(), 0, n_ty - 1)
    ty1 = torch.clamp(torch.floor(hiy / th).long(), 0, n_ty - 1)
    tx0 = torch.clamp(torch.floor(lox / tw).long(), 0, n_tx - 1)
    tx1 = torch.clamp(torch.floor(hix / tw).long(), 0, n_tx - 1)
    sy, sx = ty1 - ty0 + 1, tx1 - tx0 + 1
    big = use & ((sy > 2) | (sx > 1))
    bi = torch.arange(use.shape[0])[:, None].expand_as(use)[use]
    d = torch.zeros((use.shape[0], n_ty + 1, n_tx + 1), dtype=torch.long)
    for yy, xx, sgn in ((ty0, tx0, 1), (ty0, tx1 + 1, -1), (ty1 + 1, tx0, -1),
                        (ty1 + 1, tx1 + 1, 1)):
        d.index_put_((bi, yy[use], xx[use]), torch.full_like(bi, sgn), accumulate=True)
    ld = d.cumsum(1).cumsum(2)[:, :n_ty, :n_tx]
    return {"load": int(ld.max()), "big": int(big.sum(-1).max()),
            "span_y": int(sy[use].max()), "span_x": int(sx[use].max()),
            "ncu": int((-(-ld // 128)).sum((1, 2)).max())}


def budgets(audit: dict) -> dict:
    """chip_smoke.py::config5_tile's budgets from an audit."""
    return {"capacity": 128 * math.ceil(1.3 * audit["load"] / 128),
            "bin_big_k": 256 * math.ceil(1.3 * audit["big"] / 256),
            "rect_y": audit["span_y"] + 2, "rect_x": audit["span_x"] + 1,
            "compact_chunks": max(400, math.ceil(1.3 * audit["ncu"]))}


def poses(cfg: dict, wl: dict, sets: list) -> list[tuple[int, str, np.ndarray]]:
    """(set, label, camera-from-base) of each set's ground truth and of every
    start of the cell's bank."""
    p = wl["params"]
    out = [(k, "gt", s["Tc"]) for k, s in enumerate(sets)]
    for j in range(int(p["pool"]) * int(p["starts"])):
        k = j % len(sets)
        d = scene.unit_twist(scene.rng(int(p["bank_seed"]), 2, j))
        xi = (sets[k]["xi"] + float(p["offset"]) * d).astype(np.float32).astype(np.float64)
        out.append((k, f"start {j}", geo.se3_exp(torch.as_tensor(xi)).numpy()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--device", default="")
    a = ap.parse_args(argv)
    wl = hb.cell(a.workload)
    cfg = hb.config(wl["config"])
    p = wl["params"]
    arm = scene.arm(cfg)
    K = geo.intrinsics(cfg["H"], cfg["W"], cfg["f"])
    sc = scene.ref_scene(cfg, arm, K, device=a.device or "cpu")
    sets = [rig.capture_rig(cfg, arm, sc, scene.rng(int(p["bank_seed"]), 1, k), masks=False)
            for k in range(int(p["pool"]))]
    worst = dict(load=0, big=0, span_y=0, span_x=0, ncu=0)
    rows = []
    for k, label, Tc in poses(cfg, wl, sets):
        for rank, (sl, y0) in enumerate(shares(cfg)):
            got = loads(cfg, arm, Tc, sets[k]["lp"][sl], y0)
            rows.append({"set": k, "pose": label, "rank": rank, **got})
            worst = {n: max(worst[n], got[n]) for n in worst}
    out = {"workload": a.workload, "audit": worst, "budgets": budgets(worst),
           "config": {n: cfg["render"][n] for n in budgets(worst)}, "shares": rows}
    if a.device:
        from hec_bench.traffic import calib as tc

        tc.build_kernels(a.device)
        bh = cfg["H"] // cfg["mesh"]["tile"]
        r = tc.renderer(cfg, [arm.meshes[n] for n in arm.names], bh, cfg["W"], a.device)
        over = 0
        for k, label, Tc in poses(cfg, wl, sets):
            T = torch.as_tensor(Tc, dtype=torch.float32, device=r.device)
            for sl, y0 in shares(cfg):
                Kb = torch.as_tensor(K, device=r.device).clone()
                Kb[1, 2] -= y0
                lp = torch.as_tensor(sets[k]["lp"][sl], dtype=torch.float32, device=r.device)
                with torch.no_grad():
                    over += int(bool(r.bin_state(T, lp, Kb).overflow))
        out["overflowed_shares_at_config"] = over
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
