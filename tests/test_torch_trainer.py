"""Port parity: easyhec_torch's config, dataset, evaluators, trainer and CLI
against easyhec_tpu's, on CPU.

The end-to-end check runs ``python -m easyhec_torch.cli.run -c
configs/sim_mini.yaml --device cpu`` (the dense fused route: sim_mini leaves
compact_chunks at 0) at 120×160 on 3 frames written by JAX's
generate_dataset, for 10 steps from a perturbed ground truth, against JAX's
run_offline_calibration on the same data and config (its K1/K4 kernels in
interpret mode). Tolerances as in test_torch_calib.py: the loss trace rtol
1e-3 and the pose atol 1e-4 (summation order, renormalized by Adam).
"""
import dataclasses
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from easyhec_torch.cli import run as t_run
from easyhec_torch.config import load_config as t_load
from easyhec_torch.data import load_calib_dataset as t_load_data
from easyhec_torch.evaluators import build_evaluators as t_evaluators
from easyhec_torch.models.pose_init import lookat_init as t_lookat
from easyhec_torch.robot import build_chain as t_build_chain
from easyhec_torch.robot import parse_urdf as t_parse_urdf
from easyhec_torch.trainer import offline as t_off
from easyhec_torch.utils.logging import MetricsWriter
from easyhec_tpu.config import load_config as j_load
from easyhec_tpu.data import load_calib_dataset as j_load_data
from easyhec_tpu.data.synthetic import default_camera, generate_dataset
from easyhec_tpu.evaluators import build_evaluators as j_evaluators
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.models.pose_init import lookat_init as j_lookat
from easyhec_tpu.trainer import build_runtime as j_build_runtime
from easyhec_tpu.trainer import run_offline_calibration as j_run

ROOT = Path(__file__).resolve().parents[1]
SIM = str(ROOT / "configs" / "sim_mini.yaml")
H, W = 120, 160


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_configs_load_equal(name, monkeypatch):
    monkeypatch.chdir(ROOT)
    path = ROOT / "configs" / name
    opts = ["solver.max_lr=0.01", "render.tile_h=8", "model.use_links=[a, b]"]
    assert dataclasses.asdict(t_load(path, opts)) == dataclasses.asdict(j_load(path, opts))


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    """A 3-frame sim_mini dataset at 120×160 written by JAX's generator, and
    the CLI overrides that run it from GT perturbed in se(3)."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        d = tmp_path_factory.mktemp("sim")
        cfg = j_load(SIM, [f"model.H={H}", f"model.W={W}"])
        rt = j_build_runtime(cfg)
        fx = 1.2 * max(H, W)
        K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
        Tc = default_camera()
        generate_dataset(d / "data", rt.chain, rt.renderer, rt.link_names, Tc, K,
                         n_frames=3, seed=0)
    finally:
        os.chdir(cwd)
    xi = np.asarray(jse3.log(jnp.asarray(Tc, jnp.float32)))
    # far enough out that all 10 Adam steps (lr 3e-3) still descend
    xi = xi + np.array([0.04, -0.03, 0.03, 0.04, -0.035, 0.03], np.float32)
    init = np.asarray(jse3.exp(jnp.asarray(xi))).tolist()
    opts = [f"model.H={H}", f"model.W={W}", "solver.num_epochs=10",
            "solver.log_interval=10", f"dataset.data_dir={d / 'data'}",
            f"model.init_Tc_c2b={init}"]
    return d, opts


def test_load_calib_dataset_matches(sim_data, monkeypatch):
    monkeypatch.chdir(ROOT)
    d, _ = sim_data
    jcfg = j_load(SIM)
    jrt = j_build_runtime(jcfg)
    tchain = t_build_chain(t_parse_urdf(jcfg.model.urdf_path))
    jb = j_load_data(d / "data", jrt.chain, jrt.link_names)
    tb = t_load_data(d / "data", tchain, jrt.link_names)
    assert tb.n_frames == 3 and tb.has_gt
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(tb, f.name), getattr(jb, f.name),
                                      err_msg=f.name)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_cli_run_matches_jax_offline(sim_data):
    d, opts = sim_data
    tout, jout = d / "torch_run", d / "jax_run"
    cmd = [sys.executable, "-m", "easyhec_torch.cli.run", "-c", SIM, "--device", "cpu",
           *opts, f"output_dir={tout}"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "solved Tc_c2b" in r.stdout

    logging.getLogger("easyhec_tpu").handlers.clear()  # log.txt in this run dir
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jres = j_run(j_load(SIM, opts + [f"output_dir={jout}"]))
    finally:
        os.chdir(cwd)

    assert _files(tout) == _files(jout)
    assert {"Tc_c2b.txt", "metrics.json", "eval.json", "config.yaml",
            "checkpoints/final.npz", "metrics.jsonl", "error_maps.png",
            "images/rendered_000010.png"} <= set(_files(tout))
    tfin = np.load(tout / "checkpoints" / "final.npz")
    np.testing.assert_allclose(tfin["losses"], jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tfin["dof"], jres.dof, atol=1e-4)
    assert tfin["losses"][-1] < tfin["losses"][0]
    # the port's config.yaml (JSON) reads back in JAX as the config it ran
    jcfg_back = j_load(tout / "config.yaml")
    assert dataclasses.asdict(jcfg_back) == dataclasses.asdict(
        t_load(SIM, opts + [f"output_dir={tout}"]))
    tev = json.loads((tout / "eval.json").read_text())
    jev = json.loads((jout / "eval.json").read_text())
    assert tev.keys() == jev.keys()
    np.testing.assert_allclose([tev[k] for k in jev], [jev[k] for k in jev], atol=1e-3)


def test_evaluators_and_lookat_match():
    rng = np.random.default_rng(0)
    outs = {"rendered_masks": rng.random((2, 8, 8)), "ref_masks": rng.random((2, 8, 8)),
            "dof": np.array([0.01, 0.02, 1.0, 0.1, 0.0, 0.05], np.float32)}

    class Batch:
        Tc_c2b_gt = np.asarray(jse3.exp(jnp.asarray([0.0, 0.02, 1.0, 0.1, 0.01, 0.05])))

    for ej, et in zip(j_evaluators(["mask_iou", "pose_error"]),
                      t_evaluators(["mask_iou", "pose_error"])):
        mj, mt = ej(outs, Batch), et(outs, Batch)
        assert mj.keys() == mt.keys() and mj
        np.testing.assert_allclose([mt[k] for k in mj], [mj[k] for k in mj], atol=1e-4)
    np.testing.assert_allclose(t_lookat([1.0, 0.7, 0.8], [0, 0, 0.3]),
                               j_lookat([1.0, 0.7, 0.8], [0, 0, 0.3]), atol=1e-6)


def test_init_dof_methods(sim_data):
    _, opts = sim_data

    class Batch:
        has_gt = False
        Tc_c2b_gt = np.eye(4, dtype=np.float32)

    cfg = t_load(SIM, ["model.init_method=lookat", "model.init_lookat_eye=[1, 0.7, 0.8]",
                       "model.init_lookat_target=[0, 0, 0.3]"])
    T = t_lookat([1, 0.7, 0.8], [0, 0, 0.3])
    np.testing.assert_allclose(t_off._init_dof(cfg, Batch),
                               np.asarray(jse3.log(jnp.asarray(T))), atol=1e-5)
    for method in ("global_search", "auto"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue item 12"):
            t_off._init_dof(t_load(SIM, [f"model.init_method={method}"]), Batch)
    with pytest.raises(ValueError):
        t_off._init_dof(t_load(SIM, ["model.init_method=gt"]), Batch)


@pytest.mark.parametrize("capacity,warns", [(256, False), (8, True)])
def test_overflow_precheck_bins_frame0(sim_data, monkeypatch, caplog, capacity, warns):
    """The pre-check bins frame 0 only at the initial pose (the JAX trainer
    renders frame 0) and warns when those bins overflow."""
    monkeypatch.chdir(ROOT)
    d, opts = sim_data
    cfg = t_load(SIM, opts + [f"render.capacity={capacity}"])
    rt = t_off.build_runtime(cfg, device="cpu")
    batch = t_load_data(d / "data", rt.chain, rt.link_names)
    frames, real = [], rt.renderer.bin_state

    def spy(Tc, lp, K, **kw):
        frames.append(lp.shape[0])
        return real(Tc, lp, K, **kw)

    monkeypatch.setattr(rt.renderer, "bin_state", spy)
    logger = logging.getLogger("easyhec_torch")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger="easyhec_torch"):
        t_off._warn_if_bins_overflow(rt, batch, t_off._init_dof(cfg, batch))
    assert frames == [1]
    assert any("bin overflow" in r.message for r in caplog.records) == warns


def test_cli_refuses_unported_modes(monkeypatch):
    with pytest.raises(NotImplementedError, match="item 11"):
        t_run.main(["-c", SIM, "--iterative", "--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 14"):
        t_run.main(["-c", SIM, "--device", "cpu"])


def test_metrics_writer_without_matplotlib(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    w = MetricsWriter(tmp_path)
    with caplog.at_level(logging.WARNING, logger="easyhec_torch"):
        logging.getLogger("easyhec_torch").propagate = True
        try:
            w.image(1, "rendered", np.zeros((4, 4)))
            w.image(2, "rendered", np.zeros((4, 4)))
        finally:
            logging.getLogger("easyhec_torch").propagate = False
    w.scalars(1, mask_loss=1.0)
    w.close()
    assert not (tmp_path / "images").exists()
    assert sum("matplotlib" in r.message for r in caplog.records) == 1
    assert (tmp_path / "metrics.jsonl").read_text().count("mask_loss") == 1
    t_off._save_error_panel(tmp_path / "error_maps.png", {})  # skipped, no raise
    assert not (tmp_path / "error_maps.png").exists()


def test_setup_logger_follows_output_dir(tmp_path):
    """Two runs in one process each get their own log.txt (the JAX logger
    keeps writing to the first run's)."""
    from easyhec_torch.utils.logging import setup_logger

    for name in ("run_a", "run_b"):
        setup_logger(tmp_path / name).info("hello from %s", name)
    for h in logging.getLogger("easyhec_torch").handlers:
        h.flush()
    assert "hello from run_a" in (tmp_path / "run_a" / "log.txt").read_text()
    assert "hello from run_b" in (tmp_path / "run_b" / "log.txt").read_text()
    assert "run_b" not in (tmp_path / "run_a" / "log.txt").read_text()
