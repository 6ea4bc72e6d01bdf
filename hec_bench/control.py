"""The readings that a cell's limits are set from: for each seed, a few of
the cell's calls through the program, then the numbers its check compares
for the program and for the control, the reference put in the program's
place and computed in the precision below the configuration's (TF32
operands in its matrix products, where the configuration states float32
with TF32 off). One JSON line per seed; the program's readings are the
lower ones, the control's the upper.

    python hec_bench/control.py --workload <cell> --seeds 1 2 3 [--calls 2] [--device cuda]

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
from hec_bench.reference import explore as rex  # noqa: E402


def control_var(tr):
    def var_of(q, hyps, pick):
        return rex.variance(tr.ref, tr.arm.robot, tr.arm.names, q, hyps, prec="tf32")
    return var_of


def readings(tr, wl, records, seed: int, control: bool, per_call=None) -> dict:
    """The worst reading of each compared number over the calls; each
    call's readings are appended to ``per_call`` where it is given."""
    worst = {}
    for rec in records:
        if wl["traffic"] == "calib":
            side = tr.control_side(rec) if control else tr.program_side(rec)
            got = tr.readings(rec, side)
        else:
            var_of = (control_var(tr) if control else
                      (lambda q, h, pick, rec=rec: rec["var"][pick].astype(np.float64)))
            got = tr.readings(rec, var_of, seed)
            if control:  # the reference draws and gates for itself
                got.update(draw_mismatch=0.0, feasible_mismatch=0, path_mismatch=0)
        for k, v in got.items():
            worst[k] = float(np.maximum(worst.get(k, 0.0), v))
        if per_call is not None:
            per_call.append(got)
    return worst


def main(argv=None, cell=None, cfg=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    wl = cell or hb.cell(a.workload)
    cfg = cfg or hb.config(wl["config"])
    mod = hb.traffic(wl["traffic"])
    for seed in a.seeds:
        t0 = time.perf_counter()
        tr = mod.setup(cfg, wl, seed, a.device)
        records = [tr.call(i) for i in range(a.calls)]
        if torch.device(a.device).type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.release()
        calls = {"program": [], "control": []}
        prog = readings(tr, wl, records, seed, False, calls["program"])
        ctrl = readings(tr, wl, records, seed, True, calls["control"])
        extra = {}
        if wl["traffic"] == "calib":
            extra = {"rebins": [r["rebins"] for r in records], "overflow": any(r["overflow"] for r in records)}
        else:
            extra = {"shared": [r["shared"] for r in records], "bin_states": [r["bin_states"] for r in records],
                     "escalations": [r["escalations"] for r in records],
                     "spread_px": [r["spread_px"] for r in records]}
        print(json.dumps({"workload": wl["name"], "seed": seed, "program": prog, "control": ctrl,
                          "calls_s": (t1 - t0), "check_s": time.perf_counter() - t1, **extra,
                          "per_call": calls}),
              flush=True)
        del tr
    return 0


if __name__ == "__main__":
    sys.exit(main())
