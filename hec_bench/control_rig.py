"""The readings that a rig cell's limits are set from (traffic ``sharded``;
hec_bench/control.py does this for the one-process cells): a seed's calls
through the program on every rank, then the numbers the check compares,
for the program and for the control, the reference in the program's place
computed with TF32 operands in its matrix products (the configuration
states float32 with TF32 off). With ``--fault``, a planted fault runs on
every rank, for the limits that the control does not move. One JSON line
per seed; the program's readings are the lower ones, the control's or the
fault's the upper.

    python hec_bench/control_rig.py --workload c5-rig-1080p.calib-4card --seeds 1 2 [--calls 2] [--fault leave_out]

``--one-rank`` runs the same problems through the one-card path instead,
``easyhec_torch.models.calib.calibrate`` over every frame-view at full
height on card 0 (the chunk, capacity and span budgets doubled: a whole
frame holds both bands), with the same readings: the baseline the mesh
is measured against.

Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hec_bench import harness as hb  # noqa: E402

# Each runs on every rank before its set-up, with ``rank`` bound.
FAULTS = {
    # rank 3's [loss, g] left out of the combine's sum over the mesh
    "leave_out": """
import easyhec_torch.parallel.sharding as sh
real = sh._all_reduce
def leave_out(t, n, group=None, **kw):
    if rank == 3 and t.numel() == 7:
        t.zero_()
    return real(t, n, group, **kw)
sh._all_reduce = leave_out
""",
    # Adam's moments (not its step count) zeroed at each rebin
    "moments": """
from easyhec_torch.models import calib
real = calib._Scan._rebin
def rebin(self):
    real(self)
    for b in self.leaves:
        if b.dim():
            b.zero_()
calib._Scan._rebin = rebin
""",
    # every update zeroed: the pose never moves
    "frozen": """
from easyhec_torch.models import calib
real = calib._Scan._step
def step(self):
    d = self.dof.clone()
    real(self)
    self.dof.copy_(d)
calib._Scan._step = step
""",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one-rank", action="store_true")
    a = ap.parse_args(argv)
    hb.env_defaults()
    if a.one_rank:
        return one_rank(a)
    for seed in a.seeds:
        wl = hb.cell(a.workload)
        cfg = hb.config(wl["config"])
        if a.fault:
            wl["fault"] = FAULTS[a.fault]
        t0 = time.perf_counter()
        tr = hb.traffic(wl["traffic"]).setup(cfg, wl, seed, a.device)
        t1 = time.perf_counter()
        records = [tr.call(i) for i in range(a.calls)]
        if torch.device(a.device).type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        tr.release()
        out = {"program": [], "control": []}
        for rec in records:
            out["program"].append(tr.readings(rec, tr.program_side(rec)))
            if not a.fault:
                out["control"].append(tr.readings(rec, tr.control_side(rec)))
        worst = {side: {k: float(np.max([r[k] for r in rows])) for k in rows[0]}
                 for side, rows in out.items() if rows}
        codes = tr.end()
        print(json.dumps({"workload": wl["name"], "seed": seed, "fault": a.fault, **worst,
                          "setup_s": t1 - t0, "calls_s": [round(t2 - t1, 4)],
                          "check_s": time.perf_counter() - t2,
                          "rebins": [r["rebins"] for r in records],
                          "own_rebins": [r["own_rebins"] for r in records],
                          "overflow": any(r["overflow"] for r in records),
                          "worker_exits": codes, "per_call": out}), flush=True)
    return 0


def one_rank(a) -> int:
    """The cell's problems through calibrate on one device: seconds a call,
    rebins and the readings against the reference on that device."""
    from hec_bench import rig, scene
    from hec_bench.traffic import calib as tc

    wl = hb.cell(a.workload)
    cfg = hb.config(wl["config"])
    dev = torch.device(a.device)
    for seed in a.seeds:
        t0 = time.perf_counter()
        tr = tc.Calib.__new__(tc.Calib)  # Calib's problems and readings over the rig's sets
        p = wl["params"]
        tr.cfg, tr.wl, tr.seed, tr.device = cfg, wl, seed, dev
        tr.steps, tr.lr, tr.offset = int(p["steps"]), float(cfg["solver"]["max_lr"]), float(p["offset"])
        tc.build_kernels(dev)
        tr.arm = scene.arm(cfg)
        tr.K = scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"])
        tr.ref = scene.ref_scene(cfg, tr.arm, tr.K, device=dev)
        bank = int(p["bank_seed"])
        tr.sets = [rig.capture_rig(cfg, tr.arm, tr.ref, scene.rng(bank, 1, k))
                   for k in range(p["pool"])]
        n = int(p["pool"]) * int(p["starts"])
        tr.bank = [(k % len(tr.sets), scene.unit_twist(scene.rng(bank, 2, k))) for k in range(n)]
        tr.order = scene.rng(seed, 6).permutation(n)
        tr.renderer = tc.renderer(cfg, [tr.arm.meshes[m] for m in tr.arm.names], cfg["H"], cfg["W"],
                                  dev, scale=2)
        tr.Kt = torch.as_tensor(tr.K, device=dev)
        for s in tr.sets:
            s["lp_t"] = torch.as_tensor(s["lp"], dtype=torch.float32, device=dev)
            s["masks_t"] = s["masks"].to(dev)
        tr.call(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        secs, records = [], []
        for i in range(a.calls):
            c0 = time.perf_counter()
            records.append(tr.call(i))
            torch.cuda.synchronize()
            secs.append(round(time.perf_counter() - c0, 4))
        tr.release()
        prog = [tr.readings(rec, tr.program_side(rec)) for rec in records]
        print(json.dumps({"workload": wl["name"], "seed": seed, "one_rank": True,
                          "program": {k: max(r[k] for r in prog) for k in prog[0]},
                          "setup_s": t1 - t0, "calls_s": secs,
                          "rebins": [r["rebins"] for r in records],
                          "overflow": any(r["overflow"] for r in records),
                          "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
