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
import functools
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SIM = str(ROOT / "configs" / "sim_mini.yaml")
H, W = 120, 160


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_configs_load_equal(name, monkeypatch):
    monkeypatch.chdir(ROOT)
    path = ROOT / "configs" / name
    opts = ["solver.max_lr=0.01", "render.tile_h=8", "model.use_links=[a, b]",
            "model.init_Tc_c2b=[[1, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, 1.5], [0, 0, 0, 1]]",
            "render.fused=off", "solver.max_lr=3e-3"]
    # the port's own YAML reader against JAX's PyYAML, quirks included: 3e-3
    # (no dot) stays a string in both
    t_cfg, j_cfg = t_load(path, opts), j_load(path, opts)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.solver.max_lr == "3e-3" and t_cfg.render.fused is False
    assert t_cfg.model.init_Tc_c2b[2] == [0, 0, 1, 1.5]


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


def test_cli_run_matches_jax_offline(sim_data, monkeypatch):
    d, opts = sim_data
    tout, jout = d / "torch_run", d / "jax_run"
    cmd = [sys.executable, "-m", "easyhec_torch.cli.run", "-c", SIM, "--device", "cpu",
           *opts, f"output_dir={tout}"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "solved Tc_c2b" in r.stdout

    # log.txt in this run dir: the process-global loggers start without
    # handlers (an earlier test's would keep setup_logger from opening it),
    # and monkeypatch restores them, so none leaks into a later test
    for name in ("easyhec_tpu", "easyhec_torch"):
        monkeypatch.setattr(logging.getLogger(name), "handlers", [])
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
    for method in ("global_search", "auto"):  # the search needs a runtime
        with pytest.raises(ValueError, match="global_search"):
            t_off._init_dof(t_load(SIM, [f"model.init_method={method}"]), Batch)
    with pytest.raises(ValueError):
        t_off._init_dof(t_load(SIM, ["model.init_method=gt"]), Batch)


# A small search (30×40 scoring renders, 32 candidates, top 2, 5 Adam steps)
# in both packages, so the comparison stays quick; the full-size defaults
# run on the card (chip_smoke.py).
SMALL_SEARCH = dict(radii=(0.9, 1.6), n_dirs=8, n_roll=2, downscale=4, topk=2,
                    refine_steps=5)


def test_init_dof_global_search_matches_jax(sim_data, monkeypatch):
    from easyhec_torch.models import pose_init as tpi
    from easyhec_tpu.models import pose_init as jpi
    from easyhec_tpu.trainer import offline as j_off

    monkeypatch.chdir(ROOT)
    d, opts = sim_data
    for mod in (tpi, jpi):
        monkeypatch.setattr(mod, "global_search_init",
                            functools.partial(mod.global_search_init, **SMALL_SEARCH))
    o = [x for x in opts if not x.startswith("model.init_Tc_c2b")]
    jcfg = j_load(SIM, o + ["model.init_method=global_search"])
    jrt = j_build_runtime(jcfg)
    jb = j_load_data(d / "data", jrt.chain, jrt.link_names)
    tcfg = t_load(SIM, o + ["model.init_method=auto"])
    trt = t_off.build_runtime(tcfg, device="cpu")
    tb = t_load_data(d / "data", trt.chain, trt.link_names)
    tb = dataclasses.replace(tb, Tc_c2b_gt=np.eye(4, dtype=np.float32))  # no GT: search
    assert not tb.has_gt
    dj = np.asarray(j_off._init_dof(jcfg, jb, jrt))
    dt = t_off._init_dof(tcfg, tb, trt)
    np.testing.assert_allclose(dt, dj, atol=1e-4)


@pytest.mark.parametrize("capacity,warns", [(256, False), (8, True)])
def test_overflow_precheck_bins_frame0(sim_data, monkeypatch, caplog, capacity, warns):
    """The pre-check renders frame 0 only, at the initial pose, through
    silhouette_tiled (the counting binner and K5f, whatever the route) and
    warns when its bins overflow, as the JAX trainer does."""
    from easyhec_tpu.trainer import offline as j_off

    monkeypatch.chdir(ROOT)
    d, opts = sim_data
    o = opts + [f"render.capacity={capacity}"]
    cfg = t_load(SIM, o)
    rt = t_off.build_runtime(cfg, device="cpu")
    batch = t_load_data(d / "data", rt.chain, rt.link_names)
    frames, real = [], t_off.silhouette_tiled

    def spy(tris, H, W, tile, **kw):
        frames.append(tuple(tris.valid.shape[:-1]))
        return real(tris, H, W, tile, **kw)

    monkeypatch.setattr(t_off, "silhouette_tiled", spy)
    for name in ("easyhec_torch", "easyhec_tpu"):
        monkeypatch.setattr(logging.getLogger(name), "propagate", True)
    with caplog.at_level(logging.WARNING):
        t_off._warn_if_bins_overflow(rt, batch, t_off._init_dof(cfg, batch))
        jcfg = j_load(SIM, o)
        jrt = j_build_runtime(jcfg)
        jb = j_load_data(d / "data", jrt.chain, jrt.link_names)
        j_off._warn_if_bins_overflow(jrt, jb, j_off._init_dof(jcfg, jb))
    assert frames == [(1,)]
    for name in ("easyhec_torch", "easyhec_tpu"):
        assert any("bin overflow" in r.message for r in caplog.records
                   if r.name == name) == warns, name


def test_cli_refuses_unported_modes(monkeypatch):
    """No mode is refused since multi-device was ported: under WORLD_SIZE > 1
    both modes run, after the EASYHEC_* rendezvous (gloo with --device cpu),
    as the JAX CLI does; tests/test_torch_parallel.py runs two processes."""
    import easyhec_torch.parallel as tpar
    import easyhec_torch.trainer as ttr

    monkeypatch.setenv("WORLD_SIZE", "2")
    calls = []

    class Result:
        Tc_c2b, metrics = np.eye(4), {}

    monkeypatch.setattr(tpar, "maybe_init_from_env", lambda backend=None: calls.append(backend))
    for name in ("run_offline_calibration", "run_iterative"):
        monkeypatch.setattr(ttr, name, lambda cfg, name=name, **kw: calls.append(name) or Result)
    for extra in ([], ["--iterative"]):
        assert t_run.main(["-c", SIM, "--device", "cpu", *extra]) == 0
    assert calls == ["gloo", "run_offline_calibration", "gloo", "run_iterative"]


def test_metrics_writer_without_matplotlib(tmp_path, monkeypatch, caplog):
    """The mid-run panels and error_maps.png are written with matplotlib
    blocked (the GPU machine has none), with no warning."""
    from easyhec_torch.utils.imaging import read_png

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    w = MetricsWriter(tmp_path)
    rng = np.random.default_rng(0)
    err = rng.random((12, 16)).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger="easyhec_torch"):
        logging.getLogger("easyhec_torch").propagate = True
        try:
            w.image(1, "error_map", err)
            w.image(2, "rendered", np.zeros((12, 16), np.float32))
        finally:
            logging.getLogger("easyhec_torch").propagate = False
    w.scalars(1, mask_loss=1.0)
    w.close()
    assert not caplog.records
    assert sorted(p.name for p in (tmp_path / "images").iterdir()) == [
        "error_map_000001.png", "rendered_000002.png"]
    panel = read_png(tmp_path / "images" / "error_map_000001.png")
    assert panel.shape == (12, 16, 3) and panel.dtype == np.uint8
    # a constant map is entry 0 of viridis everywhere
    flat = read_png(tmp_path / "images" / "rendered_000002.png")
    assert (flat == flat[0, 0]).all() and tuple(flat[0, 0]) == (68, 1, 84)
    assert (tmp_path / "metrics.jsonl").read_text().count("mask_loss") == 1
    masks = (rng.random((5, 12, 16)) > 0.5).astype(np.float32)
    outputs = dict(rendered_masks=masks, ref_masks=masks[::-1],
                   error_maps=np.abs(masks - masks[::-1]))
    t_off._save_error_panel(tmp_path / "error_maps.png", outputs)
    grid = read_png(tmp_path / "error_maps.png")
    pad = 2  # image_grid's: 3 rows of min(4, B) = 4 frames
    assert grid.shape == (3 * 12 + 4 * pad, 4 * 16 + 5 * pad, 3)
    top = grid[pad:pad + 12, pad:pad + 16]
    np.testing.assert_array_equal(top, np.repeat(masks[0, :, :, None] * 255, 3, -1))


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


def test_generate_dataset_matches_jax(tmp_path, monkeypatch):
    """The port's generator against JAX's for the same explicit qposes (the
    two packages draw random qposes from different generators): masks, RGB,
    depth and link ids; JAX's loader reads the port's files."""
    from easyhec_torch.data import synthetic as tsyn

    monkeypatch.chdir(ROOT)
    o = [f"model.H={H}", f"model.W={W}"]
    jrt = j_build_runtime(j_load(SIM, o))
    trt = t_off.build_runtime(t_load(SIM, o), device="cpu")
    fx = 1.2 * max(H, W)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    Tc = default_camera()
    np.testing.assert_allclose(tsyn.default_camera(), Tc, atol=1e-6)
    qs = np.array([[0.2, -0.5], [-0.6, 0.9], [0.0, 0.3]], np.float32)
    dj = generate_dataset(tmp_path / "j", jrt.chain, jrt.renderer, jrt.link_names, Tc, K,
                          qposes=qs, write_depth=True)
    dt = tsyn.generate_dataset(tmp_path / "t", trt.chain, trt.renderer, trt.link_names, Tc,
                               K, qposes=qs, write_depth=True)
    # sim_mini's 16×64 tiles: edge offsets up to 64 px (ulp 7.6e-6), summed
    np.testing.assert_allclose(dt["masks"], dj["masks"], atol=1e-4)
    np.testing.assert_allclose(dt["depth"], dj["depth"], rtol=1e-5)
    assert (dt["link_id"] != dj["link_id"]).mean() <= 0.01  # ties at equal depth
    assert (np.abs(dt["rgb"].astype(int) - dj["rgb"].astype(int)) > 1).mean() <= 0.01
    assert (dj["link_id"] >= 0).mean() > 0.02
    jb = j_load_data(tmp_path / "t", jrt.chain, jrt.link_names)
    jref = j_load_data(tmp_path / "j", jrt.chain, jrt.link_names)
    np.testing.assert_array_equal(jb.qpos, jref.qpos)
    assert (jb.masks != jref.masks).mean() <= 1e-3
    np.testing.assert_array_equal(jb.Tc_c2b_gt, jref.Tc_c2b_gt)
    assert sorted(p.name for p in (tmp_path / "t" / "depth").iterdir()) == [
        "000000.npy", "000001.npy", "000002.npy"]
    g = torch.Generator().manual_seed(0)
    q = tsyn.sample_qposes(g, trt.chain, 64, 0.5)
    lim = trt.chain.joint_limits * 0.5
    assert q.shape == (64, 2) and (q.numpy() >= lim[:, 0] - 1e-6).all() \
        and (q.numpy() <= lim[:, 1] + 1e-6).all()


_NO_JAX = """
import runpy, sys
for k in ("jax", "jaxlib", "optax", "easyhec_tpu", "__graft_entry__", "matplotlib", "yaml"):
    sys.modules[k] = None  # any import of it now raises ImportError
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__")
"""


def test_simulate_then_run_without_jax(tmp_path):
    """The port's simulate CLI writes a dataset and its run CLI calibrates on
    it from configs/sim_mini.yaml, with every JAX module, matplotlib and
    PyYAML blocked (the run still writes its image panels); JAX's loader
    reads the dataset."""
    data = tmp_path / "data"
    size = [f"model.H={H}", f"model.W={W}"]
    r = subprocess.run([sys.executable, "-c", _NO_JAX, "easyhec_torch.cli.simulate",
                        "-c", SIM, "--out", str(data), "--n-frames", "3", "--device", "cpu",
                        *size], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "wrote 3 frames" in r.stdout
    r = subprocess.run([sys.executable, "-c", _NO_JAX, "easyhec_torch.cli.run", "-c", SIM,
                        "--device", "cpu", *size, "solver.num_epochs=10",
                        "solver.log_interval=10", f"dataset.data_dir={data}",
                        f"output_dir={tmp_path / 'run'}"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "solved Tc_c2b" in r.stdout
    fin = np.load(tmp_path / "run" / "checkpoints" / "final.npz")
    assert np.isfinite(fin["losses"]).all()
    assert {"error_maps.png", "images/error_map_000010.png",
            "images/rendered_000010.png"} <= set(_files(tmp_path / "run"))
    cfg = j_load(SIM, size)
    jrt = j_build_runtime(cfg)
    jb = j_load_data(data, jrt.chain, jrt.link_names)
    assert jb.n_frames == 3 and jb.has_gt and jb.masks.mean() > 0.01
    # the pose-dataset mode, JAX still blocked: the same layout as JAX's
    # generate_pose_dataset writes (held to it in test_torch_tools.py)
    ring = tmp_path / "ring"
    r = subprocess.run([sys.executable, "-c", _NO_JAX, "easyhec_torch.cli.simulate",
                        "-c", SIM, "--out", str(ring), "--ring", "4", "--device", "cpu",
                        *size], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "wrote 4 ring views" in r.stdout
    assert _files(ring) == sorted(
        [f"{d}/{i:06d}.{e}" for d, e in (("color", "png"), ("mask", "png"), ("pose", "txt"))
         for i in range(4)] + ["K.txt", "diameter.txt", "model.ply", "qpos.txt"])
    poses = np.stack([np.loadtxt(ring / "pose" / f"{i:06d}.txt") for i in range(4)])
    assert poses.shape == (4, 4, 4) and float((ring / "diameter.txt").read_text()) > 0
