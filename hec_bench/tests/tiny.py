"""The cells at a size a CPU test run holds: a coarse arm (4 cm edges), small
frames, few steps, candidates and hypotheses, small tiles and budgets. The
widths of the real cells are not these; only the harness's paths are."""
from __future__ import annotations

import argparse
import contextlib
import io
import json

import torch

from hec_bench import harness as hb
from hec_bench import run as R

CALIB = {"H": 72, "W": 128, "f": 90.7}
EXPLORE = {"H": 96, "W": 192, "f": 140.0}


def cell_and_config(name: str):
    wl = hb.cell(name)
    cfg = hb.config(wl["config"])
    cfg["arm"]["max_edge"] = 0.04
    cfg["render"].update(tile_h=16, tile_w=32, capacity=1024, compact_chunks=128, bin_big_k=2048,
                         rect_y=8, rect_x=5, cull_backfaces=False)
    if wl["traffic"] == "calib":
        cfg.update(CALIB)
        wl["params"].update(frames=2, pool=2, starts=1, steps=4)
        # Four steps do not converge: the returned pose, judged against the
        # cell's 1000 steps on the card, is held here only to twice the start.
        wl["check"]["limits"]["dof_dist"] = 2 * wl["params"]["offset"]
    else:
        cfg.update(EXPLORE)
        cfg["render"]["margin"] = 2.5
        cfg["explorer"].update(n_sample_qposes=5, n_hypotheses=3, history_start=10)
        wl["params"].update(history_steps=60, tau=20.0)
        if not wl["params"]["shared"]:
            wl["params"]["offset"] = 0.5
        wl["check"]["candidates"] = 2
    return wl, cfg


def run_tiny(name: str, seed: int = (1 << 31) + 7, man=None, wl=None, cfg=None):
    """One run of the cell at the tiny size on the CPU: (rc, the result
    line as a dict, standard error)."""
    torch.set_num_threads(2)
    if wl is None:
        wl, cfg = cell_and_config(name)
    a = argparse.Namespace(workload=name, seed=seed, seconds=0.01, trace=0)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = R.run(a, man or hb.manifest(), wl, cfg, "cpu")
    last = out.getvalue().strip().splitlines()[-1]
    return rc, json.loads(last), err.getvalue()
