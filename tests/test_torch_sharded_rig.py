"""The four-camera rig on the mesh, on the CPU: the benchmark's rig
(hec_bench/rig.py, configuration (5)) against the program's ring and the
fold of chip_smoke.py::config5_scene; sharded_calibrate on 4 gloo ranks of
a 2x2 (data x tile) mesh at a tiny rig against the float64 reference, with
its spans; and the cell's traffic (hec_bench/traffic/sharded.py) through
hec_bench/run.py::run, sound and with one rank's term left out of the
combine.

The tiny rig: 4 views x 2 frames of 96x64 (two 32-row bands), f = 70 (the
cell's field of view), the mini arm at 4 cm edges, 16x32 tiles. Its ranks
are processes of their own (one torch thread each), as on the cards.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hec_bench import harness as hb
from hec_bench import rig, scene
from hec_bench.control_rig import FAULTS
from hec_bench.reference import adam
from hec_bench.reference.render import loss_and_grad
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CELL = "c5-rig-1080p.calib-4card"
SEED = (1 << 31) + 29
STEPS, CHUNK = 6, 4  # two chunks: 4 steps, then 2


def tiny_cell():
    """The cell and its configuration at the tiny rig's size, its check's
    limits the cell's but dof_dist: a few steps do not converge, so the
    returned pose is held to twice the start's offset (as
    hec_bench/tests/tiny.py holds traffic calib's)."""
    wl = hb.cell(CELL)
    cfg = hb.config(wl["config"])
    cfg.update(H=64, W=96, f=70.0)
    cfg["arm"]["max_edge"] = 0.04
    cfg["rig"]["frames"] = 2
    cfg["render"].update(tile_h=16, tile_w=32, capacity=2048, compact_chunks=8,
                         bin_big_k=2048, rect_y=8, rect_x=5)
    wl["params"].update(pool=2, starts=1, steps=4)
    wl["check"]["limits"]["dof_dist"] = 2 * wl["params"]["offset"]
    return wl, cfg


def test_rig_matches_the_programs_ring_and_fold(monkeypatch):
    """hec_bench/rig.py's cameras and folded link poses (float64) against
    easyhec_torch's camera.ring_poses and config5_scene's fold (float32),
    on config (5)'s captures."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from easyhec_torch.geometry import camera, se3

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    wl = hb.cell(CELL)
    cfg = hb.config(wl["config"])
    r = cfg["rig"]
    Tcs = rig.ring_poses(r["views"], r["radius"], r["height"], r["target"])
    theirs = se3.inverse(camera.ring_poses(r["views"], r["radius"], r["height"],
                                           target=torch.tensor(r["target"])))
    np.testing.assert_allclose(Tcs, theirs.numpy(), atol=2e-6)

    _, lp, K, xi = chip_smoke.config5_scene()
    a = scene.arm(cfg)
    lim = a.robot.limits.astype(np.float64) * cfg["qpos_fraction"]
    qs = np.random.default_rng(0).uniform(lim[:, 0], lim[:, 1], (r["frames"], len(lim)))
    ours = rig.fold(Tcs, scene.geo.fk(a.robot, qs.astype(np.float32).astype(np.float64),
                                      a.names))
    assert ours.shape == tuple(lp.shape) == (80, 3, 4, 4)
    np.testing.assert_allclose(ours, lp.numpy(), atol=2e-5)
    np.testing.assert_allclose(scene.geo.se3_log_np(Tcs[0]), xi.numpy(), atol=2e-6)
    np.testing.assert_array_equal(scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"]), K.numpy())


RANK = r'''
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
rank, rdv, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from hec_bench import rig, scene
from hec_bench.traffic.calib import renderer
from easyhec_torch.parallel import init_distributed, make_mesh, sharded_calibrate
from easyhec_torch.utils import profiling
init_distributed(rdv, num_processes=4, process_id=rank)
wl, cfg = pickle.loads(open(d + "/cell.pkl", "rb").read())
a = scene.arm(cfg)
K = scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"])
s = rig.capture_rig(cfg, a, scene.ref_scene(cfg, a, K), scene.rng(7, 1, 0))
band = renderer(cfg, [a.meshes[n] for n in a.names], cfg["H"] // 2, cfg["W"], "cpu")
d0 = (s["xi"] + 0.05 * scene.unit_twist(scene.rng(7, 2, 0))).astype(np.float32)
profiling.clear()
out = sharded_calibrate(d0, band, make_mesh(2, 2), s["lp"].astype(np.float32), K,
                        s["masks"].numpy(), num_steps={steps}, max_lr=3e-3, rebin_every=0,
                        chunk={chunk})
spans = [tuple(sp) for sp in profiling.spans()]
res = dict(out=[x.numpy() for x in out], spans=spans, d0=d0)
open(d + f"/out{{rank}}.pkl", "wb").write(pickle.dumps(res))
torch.distributed.destroy_process_group()
'''


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """sharded_calibrate on 4 gloo ranks of a (2 data x 2 tile) mesh over
    the tiny rig, STEPS steps in chunks of CHUNK: each rank's (dof, losses,
    history), its spans and the start."""
    d = tmp_path_factory.mktemp("rig")
    wl, cfg = tiny_cell()
    (d / "cell.pkl").write_bytes(pickle.dumps((wl, cfg)))
    script = d / "rank.py"
    script.write_text(RANK.format(root=str(ROOT), steps=STEPS, chunk=CHUNK))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), f"file://{d / 'rdv'}", str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(os.environ, OMP_NUM_THREADS="1")) for r in range(4)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:  # a hung rank never outlives the test
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return cfg, [pickle.loads((d / f"out{r}.pkl").read_bytes()) for r in range(4)]


def test_sharded_calibrate_on_four_ranks_matches_the_reference(four_ranks):
    """The first three losses against the float64 loss at the same poses,
    and the first update against Adam's first from the float64 gradient,
    within the cell's limits (loss_rel, step1_rel); every rank's pose,
    losses and history bit-identical."""
    cfg, outs = four_ranks
    wl = hb.cell(CELL)
    lim = wl["check"]["limits"]
    _, losses, history = outs[0]["out"]
    for o in outs[1:]:
        for a, b in zip(o["out"], outs[0]["out"]):
            np.testing.assert_array_equal(a, b)
    a = scene.arm(cfg)
    K = scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"])
    sc = scene.ref_scene(cfg, a, K)
    s = rig.capture_rig(cfg, a, sc, scene.rng(7, 1, 0))
    ref = [loss_and_grad(sc, history[j], s["lp"], s["masks"], grad=j == 0) for j in range(3)]
    ref_l = np.array([r[0] for r in ref])
    assert np.max(np.abs(losses[:3] - ref_l) / ref_l) <= lim["loss_rel"]
    g = ref[0][1]
    step = history[1].astype(np.float64) - history[0]
    count = np.abs(g) >= 1e-3 * np.median(np.abs(g))
    assert np.max(np.abs(step - adam.first_step(g, 3e-3))[count]) / 3e-3 <= lim["step1_rel"]
    np.testing.assert_array_equal(history[0], outs[0]["d0"])
    assert losses.shape == (STEPS,) and np.isfinite(losses).all()


def test_sharded_calibrate_spans(four_ranks):
    """shard.call at the root with its counts, shard.prepare, each chunk's
    calib.chunk.queue and calib.chunk.read then shard.flags below it; the
    collectives a rank issued: one all-reduce a step and one a chunk."""
    _, outs = four_ranks
    chunks = -(-STEPS // CHUNK)
    calls = []
    for o in outs:
        sp = o["spans"]
        (call,) = [s for s in sp if s[3] == "shard.call"]
        assert call[1] == 0 and call[2] == call[0]
        below = [s[3] for s in sorted(sp, key=lambda s: s[4]) if s[1] == call[0]]
        assert below == (["shard.prepare"]
                         + ["calib.chunk.queue", "calib.chunk.read", "shard.flags"] * chunks)
        assert all(s[2] == call[0] for s in sp)
        c = call[6]
        assert c["collectives"] == STEPS + chunks
        assert c["overflow"] == 0 and chunks <= c["own_rebins"] <= c["rebins"]
        calls.append(c)
    assert len({c["rebins"] for c in calls}) == 1
    assert max(c["own_rebins"] for c in calls) <= calls[0]["rebins"]


RANK0 = r'''
import argparse, json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from hec_bench import harness as hb
from hec_bench import run as R
wl, cfg = json.loads(open(sys.argv[1]).read())
a = argparse.Namespace(workload=wl["name"], seed=int(sys.argv[2]), seconds=0.01, trace=0)
sys.exit(R.run(a, hb.manifest(), wl, cfg, "cpu"))
'''


@pytest.mark.parametrize("fault", [None, "leave_out"], ids=["sound", "rank_left_out"])
def test_the_traffic_through_the_harness(tmp_path, fault):
    """hec_bench/run.py::run with the cell's traffic at the tiny rig, rank 0
    a process that loads no JAX: a well-formed last line, correct when
    sound; not correct with rank 3's [loss, g] left out of the combine's
    sum (loss_rel reads it), while the ranks still agree."""
    wl, cfg = tiny_cell()
    if fault:
        wl["fault"] = FAULTS[fault]
    (tmp_path / "cell.json").write_text(json.dumps([wl, cfg]))
    (tmp_path / "rank0.py").write_text(RANK0.format(root=str(ROOT)))
    out = subprocess.run([sys.executable, str(tmp_path / "rank0.py"), str(tmp_path / "cell.json"),
                          str(SEED)], capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    d = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(d["metrics"]) == {"calib_s", "setup_s"}
    assert all(m["value"] > 0 for m in d["metrics"].values())
    assert d["device"]["count"] == 4 and d["failed"] == 0 and d["attempted"] >= 1
    checks = {k: v["value"] for k, v in d["checks"].items()}
    assert set(checks) == {"loss_rel", "last_loss_rel", "step1_rel", "dof_dist", "overflow",
                           "rank_mismatch", "jax_ranks", "worker_exits"}
    assert checks["rank_mismatch"] == checks["jax_ranks"] == checks["worker_exits"] == 0
    if fault is None:
        assert d["correct"] is True, out.stderr[-3000:]
    else:
        assert d["correct"] is False
        assert checks["loss_rel"] > wl["check"]["limits"]["loss_rel"]
