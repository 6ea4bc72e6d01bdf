"""Traffic ``calib``: offline calibrations back to back, as one lab's
machine runs them. Each call is ``easyhec_torch.models.calib.calibrate``
(the cell's steps of Adam, adaptive rebinning, the step graph captured per
call) over one capture set from the set's ground truth moved by
``offset`` along a unit se(3) direction. The work of a call depends on its
problem (the rebins follow the trajectory), so every run gets the same
bank of problems, ``pool`` capture sets with ``starts`` directions each,
made from the cell's ``bank_seed``; the run's seed orders the bank, and
the window cycles through it in that order.

The check, for a sample of the window's calls drawn from the seed, against
the float64 reference at the poses the program reached: its first three
losses (``loss_rel``, the largest relative gap) and its last
(``last_loss_rel``); its first Adam update against Adam's first update
from the reference's gradient (``step1_rel``, over the components whose
reference gradient is at least a thousandth of the median component's, as
a share of the rate); and the pose it returns, by its distance from the
capture set's ground truth (``dof_dist``, the norm of the twists'
difference). The reference does not follow its own trajectory: Adam's
second step turns on the ratio of two gradients per component, and a
rounding there parts the trajectories (PERF.md).
"""
from __future__ import annotations

import numpy as np
import torch

from hec_bench import scene
from hec_bench.reference import adam
from hec_bench.reference.render import loss_and_grad


def renderer(cfg: dict, meshes: list, H: int, W: int, device, scale: int = 1):
    """The program's RobotRenderer with the configuration's tiles, its
    capacity-class budgets times ``scale``."""
    from easyhec_torch.render import RobotRenderer, TileConfig
    from easyhec_torch.robot.mesh import TriMesh

    r = cfg["render"]
    tile = TileConfig(
        tile_h=r["tile_h"], tile_w=r["tile_w"], capacity=r["capacity"] * scale,
        binner="count", rect_y=r["rect_y"], rect_x=r["rect_x"], margin=r["margin"],
        cull_backfaces=r["cull_backfaces"], fused=True, bwd_band_only=True,
        bin_big_k=r["bin_big_k"] * scale, bin_subsort_rows=r["bin_subsort_rows"],
        compact_chunks=r["compact_chunks"] * scale, bwd_chunks=0)
    return RobotRenderer([TriMesh(*m) for m in meshes], H, W, tile=tile, device=device)


def build_kernels(device) -> None:
    if torch.device(device).type == "cuda":
        from easyhec_torch.ops import _build

        _build.build_all()


class Calib:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        p = wl["params"]
        self.cfg, self.wl, self.seed, self.device = cfg, wl, int(seed), device
        self.steps, self.lr, self.offset = int(p["steps"]), float(cfg["solver"]["max_lr"]), float(p["offset"])
        build_kernels(device)
        self.arm = scene.arm(cfg)
        self.K = scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"])
        self.ref = scene.ref_scene(cfg, self.arm, self.K, device=device)
        bank = int(p["bank_seed"])
        self.sets = [scene.capture_set(cfg, self.arm, self.ref, scene.rng(bank, 1, i), p["frames"])
                     for i in range(p["pool"])]
        n = int(p["pool"]) * int(p["starts"])
        self.bank = [(k % len(self.sets), scene.unit_twist(scene.rng(bank, 2, k))) for k in range(n)]
        self.order = scene.rng(seed, 6).permutation(n)
        self.renderer = renderer(cfg, [self.arm.meshes[n] for n in self.arm.names],
                                 cfg["H"], cfg["W"], device)
        dev = self.renderer.device
        self.Kt = torch.as_tensor(self.K, device=dev)
        for s in self.sets:
            s["lp_t"] = torch.as_tensor(s["lp"], dtype=torch.float32, device=dev)
            s["masks_t"] = s["masks"].to(dev)
        self.call(-1)  # the warm call: kernels loaded, every shape of a call run once

    def problem(self, i: int) -> tuple[int, np.ndarray]:
        """Call i's capture set and start twist (float32)."""
        k, d = self.bank[self.order[i % len(self.order)]]
        return k, (self.sets[k]["xi"] + self.offset * d).astype(np.float32)

    def call(self, i: int) -> dict:
        from easyhec_torch.models.calib import calibrate

        k, d0 = self.problem(i)
        s = self.sets[k]
        res = calibrate(d0, self.renderer, s["lp_t"], self.Kt, s["masks_t"],
                        num_steps=self.steps, max_lr=self.lr,
                        rebin_every=int(self.cfg["solver"]["rebin_every"]))
        return {"i": i, "set": k, "d0": d0, "losses": res.losses, "history": res.history,
                "dof": res.dof, "rebins": res.rebins, "overflow": res.overflow}

    # ------------------------------------------------------------ layers

    def loss_inputs(self):
        """(renderer, twist, link poses, K, masks) of capture set 0 at its
        ground truth: the loss entry's inputs at the cell's shapes."""
        s = self.sets[0]
        dof = torch.as_tensor(s["xi"], dtype=torch.float32, device=self.renderer.device)
        return self.renderer, dof, s["lp_t"], self.Kt, s["masks_t"]

    def release(self) -> None:
        self.renderer = None
        for s in self.sets:
            s.pop("lp_t", None)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def sample(self, records: list, seed: int) -> list:
        n = min(int(self.wl["check"]["calls"]), len(records))
        idx = scene.rng(seed, 3).choice(len(records), n, replace=False)
        return [records[k] for k in sorted(idx)]

    def readings(self, rec: dict, side: dict) -> dict:
        """The numbers compared for one call: ``side`` holds the first
        three losses, the last loss, the first update and (the program's
        side only) the returned pose, of the program or of the control in
        its place."""
        s = self.sets[rec["set"]]
        h = rec["history"]
        ref = [loss_and_grad(self.ref, h[j], s["lp"], s["masks"], grad=j == 0) for j in range(3)]
        ref_l = np.array([r[0] for r in ref])
        g = ref[0][1]
        ref_last, _ = loss_and_grad(self.ref, h[-1], s["lp"], s["masks"], grad=False)
        count = np.abs(g) >= 1e-3 * np.median(np.abs(g))
        out = {
            "loss_rel": float(np.max(np.abs(side["l3"] - ref_l) / ref_l)),
            "last_loss_rel": abs(side["last"] - ref_last) / ref_last,
            "step1_rel": float(np.max(np.abs(side["step"] - adam.first_step(g, self.lr))[count]) / self.lr),
        }
        if "dof" in side:
            out["dof_dist"] = float(np.linalg.norm(side["dof"].astype(np.float64) - s["xi"]))
        return out

    def program_side(self, rec: dict) -> dict:
        h = rec["history"].astype(np.float64)
        return {"l3": rec["losses"][:3].astype(np.float64), "last": float(rec["losses"][-1]),
                "step": h[1] - h[0], "dof": rec["dof"]}

    def control_side(self, rec: dict, prec: str = "tf32") -> dict:
        s = self.sets[rec["set"]]
        h = rec["history"]
        ctl = [loss_and_grad(self.ref, h[j], s["lp"], s["masks"], prec, grad=j == 0) for j in range(3)]
        last, _ = loss_and_grad(self.ref, h[-1], s["lp"], s["masks"], prec, grad=False)
        return {"l3": np.array([c[0] for c in ctl]), "last": last,
                "step": adam.first_step(ctl[0][1], self.lr)}

    def check(self, records: list, seed: int):
        limits = self.wl["check"]["limits"]
        worst = {k: 0.0 for k in limits}
        for rec in self.sample(records, seed):
            for k, v in self.readings(rec, self.program_side(rec)).items():
                worst[k] = float(np.maximum(worst[k], v))  # a NaN stays
        overflow = any(r["overflow"] for r in records)
        checks = [(k, worst[k], limits[k]) for k in limits] + [("overflow", int(overflow), 0)]
        ok = all(v <= lim for _, v, lim in checks)
        return ok, checks


def setup(cfg, wl, seed, device):
    return Calib(cfg, wl, seed, device)
