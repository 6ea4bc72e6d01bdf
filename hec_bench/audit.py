"""Bin-load audit of an explore cell with the program's own binner, on the
CPU or the card: the largest tile load and the most compact chunks a
frame uses, over scoring batches of the cell's candidates at its
hypotheses, with budgets far above any load; then the same batches at the
configuration's budgets (doubled, as the explorer doubles them) must not
overflow.

    python hec_bench/audit.py --workload franka-1080p.explore-wide --seed 1 --batches 40 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hec_bench import harness as hb  # noqa: E402
from hec_bench import scene  # noqa: E402
from hec_bench.traffic import calib as tc  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    from easyhec_torch.geometry import se3
    from easyhec_torch.robot import build_chain, parse_urdf

    wl = hb.cell(a.workload)
    cfg = hb.config(wl["config"])
    e = cfg["explorer"]
    tc.build_kernels(a.device)
    arm = scene.arm(cfg)
    meshes = [arm.meshes[n] for n in arm.names]
    ds = int(e["render_downscale"])
    H, W = cfg["H"] // ds, cfg["W"] // ds
    K = torch.as_tensor(scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"], ds), device=a.device)
    chain = build_chain(parse_urdf(scene.HERE / cfg["arm"]["urdf"]))
    big = dict(cfg, render=dict(cfg["render"], capacity=8192, compact_chunks=4096, bin_big_k=65536))
    r_big = tc.renderer(big, meshes, H, W, a.device)
    r_cfg = tc.renderer(cfg, meshes, H, W, a.device, scale=2)
    g = scene.rng(a.seed, 9)
    lim = arm.robot.limits * np.float32(e["limit_fraction"])
    load = chunks = over = 0
    for b in range(a.batches):
        Tc = scene.camera(cfg, g)
        xi = scene.geo.se3_log_np(Tc) + 0.08 * g.uniform() * scene.unit_twist(g)
        T = se3.exp(torch.as_tensor(xi, dtype=torch.float32, device=a.device))
        q = torch.as_tensor(g.uniform(lim[:, 0], lim[:, 1], (5, len(lim))).astype(np.float32),
                            device=a.device)
        lp = chain.fk(q)[:, [chain.link_index(n) for n in arm.names]]
        with torch.no_grad():
            st = r_big.bin_state(T, lp, K)
            load = max(load, int(st.counts.max()))
            chunks = max(chunks, int(st.ncu.max()))
            over += int(bool(r_cfg.bin_state(T, lp, K).overflow))
    out = {"workload": a.workload, "scoring": f"{W}x{H}", "batches": a.batches, "seed": a.seed,
           "max_tile_load": load, "max_chunks_per_frame": chunks,
           "explorer_capacity": 2 * cfg["render"]["capacity"],
           "explorer_compact_chunks": 2 * cfg["render"]["compact_chunks"],
           "overflowed_batches_at_config": over}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
