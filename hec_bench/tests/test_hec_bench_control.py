"""The checks that decide ``correct`` fail what they should, at a tiny size
on the CPU: the control (the reference in TF32 put in the program's place)
reads above a limit of each cell, and a run with the timed path broken
underneath comes out not correct, once for each fault the cell can have.
The limits are the cells' own. The control's readings at the cells' sizes
are taken on the card with hec_bench/control.py (PERF.md lists them)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from hec_bench import control
from hec_bench import harness as hb
from hec_bench.tests import tiny

CELLS = [m["name"] for m in hb.manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit_and_the_program_passes(name):
    torch.set_num_threads(2)
    wl, cfg = tiny.cell_and_config(name)
    tr = hb.traffic(wl["traffic"]).setup(cfg, wl, 2**31 + 21, "cpu")
    records = [tr.call(0)]
    limits = wl["check"]["limits"]
    prog = control.readings(tr, wl, records, 2**31 + 21, control=False)
    ctrl = control.readings(tr, wl, records, 2**31 + 21, control=True)
    assert all(prog[k] <= limits[k] for k in limits if k in prog), prog
    assert any(ctrl[k] > limits[k] for k in limits if k in ctrl), ctrl


def _zero_updates(monkeypatch):
    from easyhec_torch.models import calib

    real = calib.make_optimizer

    class Frozen:
        """The optimizer with every update zeroed: the pose never moves."""

        def __init__(self, opt):
            self.opt = opt

        def __getattr__(self, name):
            return getattr(self.opt, name)

        def update(self, g, state, params):
            u, s = self.opt.update(g, state, params)
            return torch.zeros_like(u), s

    def make(*a, **k):
        return Frozen(real(*a, **k))

    monkeypatch.setattr(calib, "make_optimizer", make)


def _half_batch_calib(monkeypatch):
    from easyhec_torch.models import calib

    real = calib._robust_mean
    monkeypatch.setattr(calib, "_robust_mean",
                        lambda per_frame, masks, d: real(per_frame[: max(1, len(per_frame) // 2)],
                                                         masks[: max(1, len(per_frame) // 2)], d))


def _altered_loss(monkeypatch):
    from easyhec_torch.render import fused

    real = fused.loss_fused
    monkeypatch.setattr(fused, "loss_fused", lambda *a, **k: real(*a, **k) * 1.001)


def _half_hypotheses(monkeypatch):
    from easyhec_torch.models.explorer import SpaceExplorer

    real = SpaceExplorer._score
    monkeypatch.setattr(SpaceExplorer, "_score",
                        lambda self, q, h, K, **k: real(self, q, h[: max(2, len(h) // 2)], K, **k))


def _altered_silhouette(monkeypatch):
    from easyhec_torch.models import explorer

    real = explorer.silhouette_compact
    monkeypatch.setattr(explorer, "silhouette_compact", lambda *a, **k: real(*a, **k) * 0.99)


FAULTS = [
    ("xarm7-720p.calib", _zero_updates),
    ("xarm7-720p.calib", _half_batch_calib),
    ("xarm7-720p.calib", _altered_loss),
    ("franka-1080p.explore-wide", _half_hypotheses),
    ("franka-1080p.explore-wide", _altered_silhouette),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    rc, d, err = tiny.run_tiny(name)
    assert rc == 0
    assert d["correct"] is False, d["checks"]
    assert any(c["value"] > c["limit"] for c in d["checks"].values())


def test_a_nan_reading_is_not_correct():
    """A NaN in what the program returns reads NaN, and NaN passes no limit."""
    torch.set_num_threads(2)
    wl, cfg = tiny.cell_and_config("xarm7-720p.calib")
    tr = hb.traffic("calib").setup(cfg, wl, 2**31 + 23, "cpu")
    rec = tr.call(0)
    rec["losses"] = rec["losses"].copy()
    rec["losses"][1] = np.nan
    ok, checks = tr.check([rec, dict(rec, i=1)], 2**31 + 23)
    assert not ok
    assert np.isnan(dict((k, v) for k, v, _ in checks)["loss_rel"])
