"""Port parity: easyhec_torch.trainer.run_iterative (the online loop:
capture → calibrate → explore → plan → move) against easyhec_tpu's on the
CPU, and ``cli.run --iterative`` with every JAX module blocked.

The loop runs 2 rounds on the mini arm (MINI_URDF) at 48×64 on the compact
fused route with adaptive rebinning, scoring 8 candidates × 3 hypotheses
at 24×32, planning with the self-collision spheres. The port's explorer
draws are replaced by the JAX explorer's (test_torch_explorer.jax_draws).
Held: the same chosen qpos in every round, round 0's loss trace within
calibrate's parity tolerance (rtol 1e-3, test_torch_calib.py), the final
pose within 1e-3, the captured masks, the debug scenes' posed robot meshes
(1e-5), and the same capture, checkpoint and output file lists.
"""
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import MINI_URDF
from easyhec_torch.config import Config as TConfig
from easyhec_torch.models import explorer as tex
from easyhec_torch.trainer import run_iterative as t_run_iterative
from easyhec_tpu.config import Config as JConfig
from easyhec_tpu.data.synthetic import default_camera
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.trainer import run_iterative as j_run_iterative

from test_torch_explorer import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SIM = str(ROOT / "configs" / "sim_mini.yaml")
H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)


def _config(cls, urdf, out: Path):
    cfg = cls()
    m, r, s, e = cfg.model, cfg.render, cfg.solver, cfg.explorer
    m.urdf_path, m.use_links, m.H, m.W = str(urdf), ["base", "upper", "fore"], H, W
    r.tile_h, r.tile_w, r.capacity, r.bin_big_k = 16, 32, 256, 128
    r.fused, r.compact_chunks = True, 8
    s.num_epochs, s.explore_iters, s.rebin_every = 20, 2, 0
    e.n_sample_qposes, e.n_hypotheses, e.history_start = 8, 3, 8
    e.self_collision_check, e.use_workspace_boundary = True, False
    cfg.dbg = True  # the per-round Scene3D recording
    cfg.dataset.data_dir = str(out / "captures")
    cfg.output_dir = str(out / "run")
    return cfg


def _ply_numbers(path: Path) -> np.ndarray:
    body = path.read_text().split("end_header\n", 1)[1]
    return np.array(body.split(), np.float64)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_run_iterative_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(tex, "draw_hypotheses_and_candidates", jax_draws)
    # Both packages' loggers are process-global: a handler left by an earlier
    # test in this process would keep JAX's setup_logger from opening this
    # run's log.txt. Start both without handlers; monkeypatch restores them.
    for name in ("easyhec_tpu", "easyhec_torch"):
        monkeypatch.setattr(logging.getLogger(name), "handlers", [])
    urdf = tmp_path / "mini_arm.urdf"
    urdf.write_text(MINI_URDF)
    Tc = default_camera(distance=1.0, azimuth_deg=30, height=0.6, target=(0, 0, 0.3))
    init = np.asarray(jse3.log(jnp.asarray(Tc))) + np.array(
        [0.02, -0.02, 0.015, 0.01, -0.01, 0.015], np.float32)
    init_T = np.asarray(jse3.exp(jnp.asarray(init))).tolist()
    runs = {}
    for name, cls, fn, kw in (("j", JConfig, j_run_iterative, {}),
                              ("t", TConfig, t_run_iterative, {"device": "cpu"})):
        cfg = _config(cls, urdf, tmp_path / name)
        cfg.model.init_Tc_c2b = init_T
        runs[name] = fn(cfg, Tc_c2b_gt=Tc, K=K, **kw)
    j, t = tmp_path / "j", tmp_path / "t"
    assert _files(t / "captures") == _files(j / "captures")
    assert _files(t / "run") == _files(j / "run")
    assert _files(t / "captures") == [
        "K.txt", "color/000000.png", "color/000001.png", "mask/000000.png",
        "mask/000001.png", "qpos/000000.txt", "qpos/000001.txt"]
    # the qpos each round moved to: round 0's explored and planned choice
    for i in range(2):
        qj = np.loadtxt(j / "captures" / "qpos" / f"{i:06d}.txt")
        np.testing.assert_array_equal(np.loadtxt(t / "captures" / "qpos" / f"{i:06d}.txt"), qj)
    assert np.abs(qj).max() > 0  # the arm moved after round 0
    r0j = np.load(j / "run" / "checkpoints" / "round_000.npz")
    r0t = np.load(t / "run" / "checkpoints" / "round_000.npz")
    np.testing.assert_allclose(r0t["losses"], r0j["losses"], rtol=1e-3)
    assert r0j["losses"][-1] < r0j["losses"][0]
    np.testing.assert_allclose(runs["t"].dof, runs["j"].dof, atol=1e-3)
    assert runs["t"].metrics.keys() == runs["j"].metrics.keys()
    for i in range(2):  # the Scene3D robots: the same posed meshes
        for name in ("robot_current", "robot_proposed"):
            pj = _ply_numbers(j / "run" / "scenes" / f"{i:05d}" / f"{name}.ply")
            pt = _ply_numbers(t / "run" / "scenes" / f"{i:05d}" / f"{name}.ply")
            np.testing.assert_allclose(pt, pj, atol=1e-5)
    import cv2

    for i in range(2):
        mj = cv2.imread(str(j / "captures" / "mask" / f"{i:06d}.png"), cv2.IMREAD_UNCHANGED)
        mt = cv2.imread(str(t / "captures" / "mask" / f"{i:06d}.png"), cv2.IMREAD_UNCHANGED)
        assert mj.mean() > 1 and (mt != mj).mean() <= 1e-3


_NO_JAX = """
import runpy, sys
for k in ("jax", "jaxlib", "optax", "easyhec_tpu", "__graft_entry__", "yaml"):
    sys.modules[k] = None  # any import of it now raises ImportError
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__")
"""


def test_cli_iterative_without_jax(tmp_path):
    """``cli.simulate`` then ``cli.run --iterative --device cpu`` on sim_mini
    at 120×160 with every JAX module and PyYAML blocked: three rounds against the
    simulated GT, from the GT perturbed in se(3)."""
    data = tmp_path / "data"
    size = ["model.H=120", "model.W=160"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _NO_JAX, "easyhec_torch.cli.simulate",
                        "-c", SIM, "--out", str(data), "--n-frames", "3", "--device", "cpu",
                        *size], cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    r = subprocess.run([sys.executable, "-c", _NO_JAX, "easyhec_torch.cli.run", "-c", SIM,
                        "--iterative", "--device", "cpu", *size, "solver.num_epochs=20",
                        f"dataset.data_dir={data}", f"output_dir={tmp_path / 'run'}"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "simulated closed loop against GT" in r.stdout and "solved Tc_c2b" in r.stdout
    run = tmp_path / "run"
    assert [p.name for p in sorted((run / "checkpoints").glob("round_*.npz"))] == [
        "round_000.npz", "round_001.npz", "round_002.npz"]
    assert len(list((run / "captures" / "mask").glob("*.png"))) == 3
    assert (run / "Tc_c2b.txt").exists() and (run / "metrics.json").exists()
    log = (run / "log.txt").read_text()
    assert "explore 0:" in log and "explore 1:" in log
    # the GT dataset is never written to
    assert sorted(p.name for p in (data / "mask").iterdir()) == [
        "000000.png", "000001.png", "000002.png"]


def test_run_iterative_needs_gt_and_k_without_hardware(tmp_path):
    urdf = tmp_path / "mini_arm.urdf"
    urdf.write_text(MINI_URDF)
    cfg = _config(TConfig, urdf, tmp_path)
    with pytest.raises(ValueError, match="Tc_c2b_gt and K"):
        t_run_iterative(cfg, device="cpu")


def test_perturbed_start_matches_jax_cli():
    """The simulated loop's start pose, as easyhec_tpu/cli/run.py:398-409
    computes it (se(3) log, numpy normal(0, 0.02) from solver.seed, exp)."""
    from easyhec_torch.cli.run import perturbed_start

    Tc = default_camera(distance=1.0, azimuth_deg=30, height=0.6, target=(0, 0, 0.3))
    for seed in (0, 7):
        xi = np.asarray(jse3.log(jnp.asarray(Tc, jnp.float32)))
        xi = (xi + np.random.default_rng(seed).normal(0, 0.02, 6)).astype(np.float32)
        want = np.asarray(jse3.exp(jnp.asarray(xi)))
        np.testing.assert_allclose(np.asarray(perturbed_start(Tc, seed)), want, atol=1e-6)


def test_live_resolution_and_overflow_escalation(tmp_path):
    """The renderer is rebuilt at the first capture's resolution, a bin
    overflow in calibrate doubles the budgets and restarts the round, and a
    resolution change after the first frame raises."""
    from easyhec_torch.io.interfaces import RendererMaskSource, SimArm, SimCamera
    from easyhec_torch.render import RobotRenderer, TileConfig
    from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf

    urdf = tmp_path / "mini_arm.urdf"
    urdf.write_text(MINI_URDF)
    model = parse_urdf(urdf)
    chain = build_chain(model)
    names = ["base", "upper", "fore"]
    meshes = load_link_meshes(model, link_names=names)
    live = RobotRenderer([meshes[n] for n in names], H, W, tile=TileConfig(16, 32, 256),
                         device="cpu")
    Tc = default_camera(distance=1.0, azimuth_deg=30, height=0.6, target=(0, 0, 0.3))

    def cfg_for(out):
        cfg = _config(TConfig, urdf, out)
        cfg.model.H, cfg.model.W = 32, 48  # not the camera's 48×64
        cfg.render.compact_chunks, cfg.render.capacity = 0, 32  # dense route, too small
        cfg.solver.num_epochs = 10
        cfg.explorer.n_sample_qposes, cfg.explorer.n_hypotheses = 4, 2
        cfg.explorer.history_start, cfg.explorer.self_collision_check = 2, False
        cfg.model.init_Tc_c2b = np.asarray(Tc).tolist()
        cfg.dbg = False
        return cfg

    cfg = cfg_for(tmp_path / "a")
    arm = SimArm(chain.n_dof)
    cam = SimCamera(live, chain, names, Tc, K, arm)
    res = t_run_iterative(cfg, arm=arm, camera=cam, mask_source=RendererMaskSource(),
                          Tc_c2b_gt=Tc, K=K, device="cpu")
    assert (cfg.model.H, cfg.model.W) == (H, W)
    assert cfg.render.capacity > 32 and not res.overflow
    log = (tmp_path / "a" / "run" / "log.txt").read_text()
    assert "rebuilding renderer at the live resolution" in log and "escalating" in log
    assert len(arm.trajectory_log) == 2

    class Shrinking(SimCamera):
        calls = 0

        def capture(self):
            rgb, Kc = super().capture()
            type(self).calls += 1
            return (rgb[: H // 2] if type(self).calls > 1 else rgb), Kc

    cfg = cfg_for(tmp_path / "b")
    arm = SimArm(chain.n_dof)
    with pytest.raises(RuntimeError, match="resolution changed mid-run"):
        t_run_iterative(cfg, arm=arm, camera=Shrinking(live, chain, names, Tc, K, arm),
                        mask_source=RendererMaskSource(), Tc_c2b_gt=Tc, K=K, device="cpu")
