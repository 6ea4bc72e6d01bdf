"""Traffic ``explore``: online explore calls back to back. Each call is
``easyhec_torch.models.explorer.SpaceExplorer.explore`` with a fresh key
over one pose history made in set-up, built as the online trainer builds
its explorer (trainer/iterative.py::_make_explorer: scoring at 1/ds of the
frame, the capacity-class budgets doubled, the self-collision spheres from
the links' meshes as read, the workspace gate).

The history is the calibration trace of a round, made from the seed: the
ground truth plus a decaying walk, ``offset`` · exp(−k/``tau``) along the
unit se(3) direction ``direction`` with signs drawn from the seed (a
direction that moves every probe in the image, so the spread does not
hang on the draw), plus ``noise`` per step. A wide history's hypotheses
spread past margin − 2 px (every pair rebinned); a tight one stays inside
it (one bin state per batch). The cell states which (``shared``).

The check, for a sample of the window's calls and of each call's
candidates drawn from the seed (the chosen one among them): the draw from
the key (``draw_mismatch``, exact), the gates (``feasible_mismatch``,
exact, over every candidate), the variance of each sampled candidate
against the reference's float64 variance (``var_rel``: the gap over the
larger of that candidate's and the sample's median reference variance),
and the path (``path_mismatch``: calls whose shared flag differs from the
cell's).
"""
from __future__ import annotations

import copy
import sys

import numpy as np
import torch

from hec_bench import scene
from hec_bench.reference import explore as rex
from hec_bench.reference import geometry as geo
from hec_bench.traffic.calib import build_kernels, renderer


class Explore:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        p, e = wl["params"], cfg["explorer"]
        self.cfg, self.wl, self.seed, self.device = cfg, wl, int(seed), device
        build_kernels(device)
        from easyhec_torch.models.explorer import SpaceExplorer, build_link_spheres
        from easyhec_torch.robot import build_chain, parse_urdf
        from easyhec_torch.robot.mesh import TriMesh

        self.arm = scene.arm(cfg)
        ds = int(e["render_downscale"])
        self.H, self.W = cfg["H"] // ds, cfg["W"] // ds
        self.K = geo.intrinsics(cfg["H"], cfg["W"], cfg["f"], downscale=ds)
        g = scene.rng(seed, 1)
        self.Tc = scene.camera(cfg, g)
        xi = geo.se3_log_np(self.Tc)
        n = int(p["history_steps"])
        k = np.arange(n)[:, None]
        d = np.asarray(p["direction"], np.float64) * g.choice([-1.0, 1.0], 6)
        walk = float(p["offset"]) * np.exp(-k / float(p["tau"])) * d / np.linalg.norm(d)
        self.history = (xi + walk + float(p["noise"]) * g.normal(size=(n, 6))).astype(np.float32)
        chain = build_chain(parse_urdf(scene.HERE / cfg["arm"]["urdf"]))
        spheres = build_link_spheres(chain, {nm: TriMesh(*self.arm.raw[nm]) for nm in self.arm.names})
        er = renderer(cfg, [self.arm.meshes[nm] for nm in self.arm.names], self.H, self.W,
                      device, scale=2)
        self.explorer = SpaceExplorer(
            chain, er, self.arm.names, spheres=spheres, n_sample_qposes=int(e["n_sample_qposes"]),
            n_hypotheses=int(e["n_hypotheses"]), history_start=int(e["history_start"]),
            max_dist=float(e["max_dist"]), limit_fraction=float(e["limit_fraction"]),
            score_batch=int(e["score_batch"]))
        self.ref = scene.ref_scene(cfg, self.arm, self.K, self.H, self.W, device=device)
        # The warm call: two scoring batches through a copy that shares the
        # renderer; a call's batches have these shapes whatever their number.
        warm = copy.copy(self.explorer)
        warm.n_sample_qposes = 2 * warm.score_batch
        warm.explore(self.history, self.K, key=self.key(-1))

    def key(self, i: int) -> int:
        return (self.seed * 100003 + i + 1) % (1 << 62)

    def call(self, i: int) -> dict:
        x = self.explorer
        res = x.explore(self.history, self.K, key=self.key(i))
        rec = {"i": i, "key": self.key(i), "var": res.var_all, "feasible": res.feasible,
               "qpos_all": res.qpos_all, "qpos": res.qpos, "shared": bool(x.last_shared),
               "bin_states": int(x.last_bin_states), "escalations": int(x.last_escalations),
               "spread_px": float(x.last_spread_px), "max_load": int(x.last_max_load)}
        if rec["escalations"]:
            print(f"hec_bench: explore call {i} (key {rec['key']}): {rec['escalations']} "
                  f"escalations, max tile load {rec['max_load']}", file=sys.stderr)
        return rec

    # ------------------------------------------------------------ layers

    def scoring_batch(self):
        """(renderer, Tc of the history's last pose, link poses of one
        scoring batch, K, the batch's joint angles): the shapes of one
        scoring pair of the window's calls."""
        import easyhec_torch.geometry.se3 as se3

        x = self.explorer
        r = x.renderer
        dev = r.device
        q = torch.as_tensor(self.sample_qpos(x.score_batch), device=dev)
        lp = x.chain.fk(q)[:, torch.as_tensor(x.link_idx, device=dev).long()]
        T = se3.exp(torch.as_tensor(self.history[-1], device=dev))
        return r, T, lp, torch.as_tensor(self.K, device=dev), q.cpu().numpy()

    def sample_qpos(self, n: int) -> np.ndarray:
        lim = self.arm.robot.limits * np.float32(self.cfg["explorer"]["limit_fraction"])
        return scene.rng(self.seed, 4).uniform(lim[:, 0], lim[:, 1], (n, len(lim))).astype(np.float32)

    def release(self) -> None:
        self.explorer = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def hypotheses(self, key: int) -> tuple[np.ndarray, np.ndarray]:
        e = self.cfg["explorer"]
        hist = self.history[min(int(e["history_start"]), len(self.history) - 1):]
        lim = self.arm.robot.limits
        f = np.float32(e["limit_fraction"])
        sel, q = rex.draw(key, int(e["n_hypotheses"]), len(hist), int(e["n_sample_qposes"]),
                          lim[:, 0] * f, lim[:, 1] * f)
        return hist[sel], q

    def readings(self, rec: dict, var_of, seed: int) -> dict:
        """The numbers compared for one call; var_of(qpos [C, n], hyps) gives
        the side's variances of the sampled candidates (the program's are
        rec["var"])."""
        e = self.cfg["explorer"]
        hyps, q = self.hypotheses(rec["key"])
        sph = rex.spheres(self.arm.raw, self.arm.names)
        feas = rex.feasible(self.arm.robot, q, self.arm.names, sph, float(e["max_dist"]))
        g = scene.rng(seed, 5, rec["i"] + 1)
        cand = np.flatnonzero(feas)
        n = min(int(self.wl["check"]["candidates"]), len(cand))
        pick = np.unique(np.concatenate([g.choice(cand, n, replace=False),
                                         [int(np.argmax(rec["var"]))]]))
        ref = rex.variance(self.ref, self.arm.robot, self.arm.names, q[pick], hyps)
        got = var_of(q[pick], hyps, pick)
        scale = np.maximum(ref, np.median(ref))
        return {"var_rel": float(np.max(np.abs(got - ref) / scale)),
                "draw_mismatch": float(np.max(np.abs(rec["qpos_all"] - q))),
                "feasible_mismatch": int(np.sum(rec["feasible"] != feas)),
                "path_mismatch": int(rec["shared"] != bool(self.wl["params"]["shared"]))}

    def check(self, records: list, seed: int):
        limits = self.wl["check"]["limits"]
        n = min(int(self.wl["check"]["calls"]), len(records))
        idx = scene.rng(seed, 3).choice(len(records), n, replace=False)
        worst = {k: 0.0 for k in limits}
        for k in sorted(idx):
            rec = records[k]
            got = self.readings(rec, lambda q, h, pick: rec["var"][pick].astype(np.float64), seed)
            for name, v in got.items():
                worst[name] = float(np.maximum(worst[name], v))  # a NaN stays
        paths = sum(r["shared"] != bool(self.wl["params"]["shared"]) for r in records)
        worst["path_mismatch"] = max(worst.get("path_mismatch", 0), paths)
        checks = [(k, worst[k], limits[k]) for k in limits]
        esc = sum(r["escalations"] for r in records)
        print(f"hec_bench: escalations over the window: {esc}; bin states a call: "
              f"{sorted({r['bin_states'] for r in records})}", file=sys.stderr)
        return all(v <= lim for _, v, lim in checks), checks


def setup(cfg, wl, seed, device):
    return Explore(cfg, wl, seed, device)
