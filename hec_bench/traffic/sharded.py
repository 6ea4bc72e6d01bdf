"""Traffic ``sharded``: calibrations of a multi-camera rig back to back on a
mesh of ranks, one process a card, as one lab's four-card host runs them.
Each call is ``easyhec_torch.parallel.sharded_calibrate`` on the
configuration's ``make_mesh(data, tile)``, run by every rank: its steps of
Adam over the rig's frame-views (hec_bench/rig.py), each rank rendering its
data shard of frame-views in its band of rows, the step graphed where the
mesh's collectives can be captured (NCCL). The bank is traffic ``calib``'s:
``pool`` rigs with ``starts`` directions each from ``bank_seed``, a start
the rig's ground truth moved by ``offset`` along a unit se(3) direction;
the run's seed orders the bank.

Rank 0 is this process (on CUDA, card 0). ``setup`` starts ranks 1.. as
processes of this file (``--worker``), which read their set-up and then
one command a line from their standard input: rank 0 announces each call
there and the ranks run it together. The process group is NCCL on CUDA and
gloo on the CPU (``init_distributed`` as a launcher calls it, over
127.0.0.1); commands that gather results use a gloo group of their own
with a timeout. No rank outlives the run or hangs it: a worker ends when
its standard input closes (rank 0 gone), and rank 0 kills every worker on
exit, and, where a worker dies or a wait on the ranks passes its deadline,
ends the run with exit code 4.

The check is traffic ``calib``'s, computed the same way against the
float64 reference at the poses rank 0's program reached (``loss_rel``,
``last_loss_rel``, ``step1_rel``, ``dof_dist``, ``overflow``) for a
sample of the window's calls, with the reference's frames split over the
ranks, each on its own device, and the parts summed on the host in
float64; then ``rank_mismatch``, the ranks whose pose, losses or history
of any call differ from rank 0's, and ``jax_ranks``, the worker ranks that
loaded JAX or the JAX package.

A cell may carry ``fault``: Python run on each rank (``rank`` bound) before
its set-up, to plant a fault (hec_bench/control_rig.py, the tests).
"""
from __future__ import annotations

import atexit
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from datetime import timedelta
from pathlib import Path

if __name__ == "__main__":  # a worker rank
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hec_bench import harness as hb  # noqa: E402
from hec_bench import rig, scene  # noqa: E402
from hec_bench.reference import adam  # noqa: E402
from hec_bench.reference.render import loss_and_grad  # noqa: E402
from hec_bench.traffic.calib import Calib, build_kernels, renderer  # noqa: E402

SETUP_S = 300.0  # rank 0's wait on the ranks' set-up (start, rendezvous, rigs, warm call)
WAIT_S = 120.0  # any later wait on the ranks: a call, a reference part, the report
GROUP_S = 300.0  # the gloo command group's timeout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """Ranks 1..n-1 as processes of this file, started, driven and ended by
    rank 0. A watcher thread ends the run (killing every worker, exit code
    4) where a worker exits unasked or a wait passes its deadline."""

    def __init__(self, init: dict, n: int):
        self.procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker"],
                                       stdin=subprocess.PIPE, stdout=2, text=True)
                      for _ in range(1, n)]
        atexit.register(self.kill)
        self.ending = False  # the workers were asked to exit
        self.deadline = None  # (what, monotonic deadline) while rank 0 waits on the ranks
        for r, p in enumerate(self.procs, 1):
            p.stdin.write(json.dumps(dict(init, rank=r)) + "\n")
            p.stdin.flush()
        threading.Thread(target=self._watch, daemon=True).start()

    def send(self, cmd: dict) -> None:
        line = json.dumps(cmd) + "\n"
        for p in self.procs:
            p.stdin.write(line)
            p.stdin.flush()

    @contextmanager
    def waiting(self, what: str, seconds: float):
        self.deadline = (what, time.monotonic() + seconds)
        try:
            yield
        finally:
            self.deadline = None

    def _watch(self) -> None:
        while True:
            time.sleep(0.2)
            dead = [] if self.ending else [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                                           if p.poll() is not None]
            late = self.deadline is not None and time.monotonic() > self.deadline[1]
            if not (dead or late):
                continue
            why = (f"rank(s) exited: {dead}" if dead
                   else f"{self.deadline[0]} passed its deadline")
            print(f"hec_bench: {why}; ending every rank", file=sys.stderr, flush=True)
            self.kill()
            os._exit(4)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def exit(self) -> None:
        """Ask every worker to leave the process group and exit."""
        self.ending = True
        self.send({"op": "exit"})

    def join(self) -> list[int]:
        """The workers' exit codes, once each has exited."""
        codes = [p.wait() for p in self.procs]
        for p in self.procs:
            p.stdin.close()
        return codes


class Sharded(Calib):
    """One rank's share of the cell: the rigs (every rank makes all of them
    from the bank's seed, as every rank of a launcher loads all captures),
    the band renderer, the mesh. Rank 0 also drives the workers."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, rank: int = 0, port: int = 0):
        import torch.distributed as dist

        from easyhec_torch.parallel import init_distributed, make_mesh

        p, m = wl["params"], cfg["mesh"]
        self.cfg, self.wl, self.seed, self.rank = cfg, wl, int(seed), rank
        self.steps, self.lr, self.offset = int(p["steps"]), float(cfg["solver"]["max_lr"]), float(p["offset"])
        self.world = int(m["data"]) * int(m["tile"])
        if "fault" in wl:
            exec(wl["fault"], {"rank": rank})
        self.workers = None
        cuda = torch.device(device).type == "cuda"
        if rank == 0:
            build_kernels(device)  # before the workers start: they load what this built
            port = _free_port()
            init = {"cfg": cfg, "wl": wl, "seed": self.seed, "device": "cuda" if cuda else "cpu",
                    "port": port}
            self.workers = Workers(init, self.world)
        self.device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        with self._waiting("the ranks' set-up", SETUP_S):
            init_distributed(f"127.0.0.1:{port}", num_processes=self.world, process_id=rank)
            self.ctl = dist.new_group(backend="gloo", timeout=timedelta(seconds=GROUP_S))
            self.mesh = make_mesh(int(m["data"]), int(m["tile"]))
            self.arm = scene.arm(cfg)
            self.K = scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"])
            self.ref = scene.ref_scene(cfg, self.arm, self.K, device=self.device)
            bank = int(p["bank_seed"])
            self.sets = [rig.capture_rig(cfg, self.arm, self.ref, scene.rng(bank, 1, k))
                         for k in range(p["pool"])]
            for s in self.sets:  # the host arrays every rank passes
                s["lp32"] = s["lp"].astype(np.float32)
                s["masks_np"] = s["masks"].cpu().numpy()
            n = int(p["pool"]) * int(p["starts"])
            self.bank = [(k % len(self.sets), scene.unit_twist(scene.rng(bank, 2, k)))
                         for k in range(n)]
            self.order = scene.rng(seed, 6).permutation(n)
            self.renderer = renderer(cfg, [self.arm.meshes[n] for n in self.arm.names],
                                     cfg["H"] // int(m["tile"]), cfg["W"], self.device)
        if rank == 0:
            self.call(-1)  # the warm call: kernels loaded, NCCL's communicators made

    @contextmanager
    def _waiting(self, what: str, seconds: float):
        if self.workers is None:
            yield
        else:
            with self.workers.waiting(what, seconds):
                yield

    # ------------------------------------------------------------ calls

    def run_call(self, i: int) -> dict:
        """Call i on this rank: sharded_calibrate from the problem's start."""
        from easyhec_torch.parallel import sharded_calibrate
        from easyhec_torch.utils import profiling

        k, d0 = self.problem(i)
        s = self.sets[k]
        t0 = time.time_ns()
        out = sharded_calibrate(d0, self.renderer, self.mesh, s["lp32"], self.K, s["masks_np"],
                                num_steps=self.steps, max_lr=self.lr,
                                rebin_every=int(self.cfg["solver"]["rebin_every"]))
        dof, losses, history = (x.cpu().numpy() for x in out)
        # the call's counts, where the program records them (its shard.call span)
        counts = next((sp.counts for sp in reversed(profiling.spans(since_ns=t0))
                       if sp.name == "shard.call"), {})
        return {"i": i, "set": k, "d0": d0, "losses": losses, "history": history, "dof": dof,
                "rebins": counts.get("rebins"), "own_rebins": counts.get("own_rebins"),
                "overflow": bool(counts.get("overflow", 0))}

    def call(self, i: int) -> dict:
        if self.workers is None:
            return self.run_call(i)
        self.workers.send({"op": "call", "i": i})
        with self._waiting(f"call {i}", WAIT_S if i >= 0 else SETUP_S):
            return self.run_call(i)

    def release(self) -> None:
        if self.workers is not None:
            self.workers.send({"op": "release"})
        self.renderer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ reference

    def part(self, k: int, dofs: list, grads: list, prec) -> list:
        """This rank's part of the reference's (loss, gradient) of rig k at
        each twist: its contiguous share of the frame-views, scaled to the
        share of the mean over all of them (float64)."""
        s = self.sets[k]
        B = len(s["lp"])
        q = np.array_split(np.arange(B), self.world)[self.rank]
        sl = slice(int(q[0]), int(q[-1]) + 1)
        w = len(q) / B
        out = []
        for d, g in zip(dofs, grads):
            loss, grad = loss_and_grad(self.ref, np.asarray(d, np.float64), s["lp"][sl],
                                       s["masks"][sl], prec, grad=g)
            out.append((loss * w, grad * w))
        return out

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` on rank 0 (None elsewhere), on the command
        group."""
        import torch.distributed as dist

        got = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, got, dst=0, group=self.ctl)
        return got

    def reference(self, k: int, dofs: list, grads: list, prec=None) -> list:
        """(loss, gradient) of the float64 reference (``prec``: the
        control's) of rig k at each twist, its frames split over the ranks."""
        cmd = {"op": "ref", "set": k, "dofs": [np.asarray(d, np.float64).tolist() for d in dofs],
               "grads": list(grads), "prec": prec}
        self.workers.send(cmd)
        with self._waiting("the reference", WAIT_S):
            parts = self.gather(self.part(k, cmd["dofs"], grads, prec))
        return [(float(sum(p[j][0] for p in parts)), sum(p[j][1] for p in parts))
                for j in range(len(dofs))]

    # ------------------------------------------------------------ check

    def readings(self, rec: dict, side: dict) -> dict:
        """Calib.readings against the split reference."""
        s = self.sets[rec["set"]]
        h = rec["history"]
        ref = self.reference(rec["set"], [h[0], h[1], h[2], h[-1]], [True, False, False, False])
        ref_l = np.array([r[0] for r in ref[:3]])
        g = ref[0][1]
        ref_last = ref[3][0]
        count = np.abs(g) >= 1e-3 * np.median(np.abs(g))
        out = {
            "loss_rel": float(np.max(np.abs(side["l3"] - ref_l) / ref_l)),
            "last_loss_rel": abs(side["last"] - ref_last) / ref_last,
            "step1_rel": float(np.max(np.abs(side["step"] - adam.first_step(g, self.lr))[count]) / self.lr),
        }
        if "dof" in side:
            out["dof_dist"] = float(np.linalg.norm(side["dof"].astype(np.float64) - s["xi"]))
        return out

    def control_side(self, rec: dict, prec: str = "tf32") -> dict:
        h = rec["history"]
        ctl = self.reference(rec["set"], [h[0], h[1], h[2], h[-1]], [True, False, False, False],
                             prec)
        return {"l3": np.array([c[0] for c in ctl[:3]]), "last": ctl[3][0],
                "step": adam.first_step(ctl[0][1], self.lr)}

    def report(self) -> list:
        """Every worker's records of the window's calls and its JAX check."""
        self.workers.send({"op": "report"})
        with self._waiting("the ranks' report", WAIT_S):
            return self.gather(None)[1:]

    def end(self) -> list[int]:
        """Every rank leaves the process group together (NCCL's teardown
        waits for its peers); the workers' exit codes."""
        import torch.distributed as dist

        self.workers.exit()
        with self._waiting("the ranks' exit", WAIT_S):
            dist.destroy_process_group()
            return self.workers.join()

    def check(self, records: list, seed: int):
        limits = self.wl["check"]["limits"]
        reports = self.report()
        worst = {k: 0.0 for k in limits if k != "rank_mismatch"}
        for rec in self.sample(records, seed):
            for k, v in self.readings(rec, self.program_side(rec)).items():
                worst[k] = float(np.maximum(worst[k], v))  # a NaN stays
        mismatch = sum(
            any(rec["i"] not in rep["calls"]
                or not all(np.array_equal(rec[n], rep["calls"][rec["i"]][n])
                           for n in ("dof", "losses", "history"))
                for rec in records)
            for rep in reports)
        jax_ranks = sum(bool(rep["jax"]) for rep in reports)
        for r, rep in enumerate(reports, 1):
            if rep["jax"]:
                print(f"hec_bench: rank {r} loaded {rep['jax']}", file=sys.stderr)
        codes = self.end()
        overflow = any(r["overflow"] for r in records)
        checks = ([(k, worst[k], limits[k]) for k in worst] + [("overflow", int(overflow), 0)]
                  + [("rank_mismatch", mismatch, limits["rank_mismatch"]),
                     ("jax_ranks", jax_ranks, 0), ("worker_exits", sum(c != 0 for c in codes), 0)])
        ok = all(v <= lim for _, v, lim in checks)
        return ok, checks


def setup(cfg, wl, seed, device):
    return Sharded(cfg, wl, seed, device)


# ------------------------------------------------------------------ workers


def worker() -> int:
    """A worker rank: its set-up from the first line of standard input,
    then one command a line until ``exit``; it ends when standard input
    closes."""
    init = json.loads(sys.stdin.readline())
    cmds: queue.Queue = queue.Queue()
    asked = threading.Event()

    def read():
        for line in sys.stdin:
            cmds.put(json.loads(line))
        os._exit(0 if asked.is_set() else 5)  # rank 0 is gone

    threading.Thread(target=read, daemon=True).start()
    hb.env_defaults()
    tr = Sharded(init["cfg"], init["wl"], init["seed"], init["device"], init["rank"],
                 init["port"])
    calls = {}
    while True:
        cmd = cmds.get()
        op = cmd["op"]
        if op == "call":
            try:
                rec = tr.run_call(cmd["i"])
            except Exception as e:  # as on rank 0: counted there, and the run is not correct
                print(f"hec_bench: rank {tr.rank} call {cmd['i']} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
                continue
            if cmd["i"] >= 0:
                calls[cmd["i"]] = {n: rec[n] for n in ("dof", "losses", "history")}
        elif op == "release":
            tr.release()
        elif op == "ref":
            tr.gather(tr.part(cmd["set"], cmd["dofs"], cmd["grads"], cmd["prec"]))
        elif op == "report":
            tr.gather({"calls": calls, "jax": hb.jax_loaded()})
        elif op == "exit":
            import torch.distributed as dist

            asked.set()
            dist.destroy_process_group()
            return 0


if __name__ == "__main__":
    if sys.argv[1:] != ["--worker"]:
        raise SystemExit(__doc__)
    sys.exit(worker())
