"""Port parity: the remaining tools against easyhec_tpu's on the CPU.

- ``cli/diagnose`` on a 4-frame sim_mini dataset at 60×80 written by JAX's
  generator, with frames 1 and 2's qposes swapped, 20 steps a fit (the
  dense route; JAX's kernels in interpret mode), baseline, robust and
  --repair: the same report keys and artifact names; the baseline and
  robust fits' losses rtol 1e-3, IoU atol 1e-3 (the report rounds to 4
  digits), poses atol 1e-4 (summation order, renormalized by Adam, as
  test_torch_calib.py), the cross-pair matrix atol 2e-3 (rounded to 3
  digits), the image-pairing check and the assignment exactly (numpy on the
  same loaded arrays); the repair fit, which starts from each package's
  own baseline pose, at pose atol 5e-4 and IoU 1e-2, and, when the port
  starts it from JAX's baseline pose, at pose atol 1e-4 and final loss
  atol 1e-2 (a residual of a few px²);
- ``find_lr`` on JAX's quadratic (SGD and Adam): the swept lrs rtol 1e-6,
  the losses before divergence rtol 1e-5, the same divergence index and
  suggestion; and on a small brute-force calibration loss (20 Adam steps):
  losses rtol 1e-4 (the renderers agree to ~1e-5, test_torch_brute.py);
- ``EvalTimer`` marks, ``raster_roofline`` with explicit peaks (exact) and
  the port's H100 defaults; ``trace`` writes a Chrome trace;
- ``utils.live.serve`` answering ``/api/ls`` and the dashboard in both
  packages.
"""
import json
import logging
import os
import socket
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.solver.lr_finder import find_lr as t_find_lr
from easyhec_torch.utils import profiling as tprof
from easyhec_tpu.solver.lr_finder import find_lr as j_find_lr
from easyhec_tpu.utils import profiling as jprof
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SIM = str(ROOT / "configs" / "sim_mini.yaml")
H, W = 60, 80


@pytest.fixture(scope="module")
def diag_data(tmp_path_factory):
    """4 frames of sim_mini at 60×80 from JAX's generator (GT written), with
    the qpos files of frames 1 and 2 swapped."""
    from easyhec_tpu.config import load_config
    from easyhec_tpu.data.synthetic import default_camera, generate_dataset
    from easyhec_tpu.trainer import build_runtime

    d = tmp_path_factory.mktemp("diag") / "data"
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        rt = build_runtime(load_config(SIM, [f"model.H={H}", f"model.W={W}"]))
        fx = 1.2 * max(H, W)
        K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
        generate_dataset(d, rt.chain, rt.renderer, rt.link_names, default_camera(), K,
                         n_frames=4, seed=1)
    finally:
        os.chdir(cwd)
    q1, q2 = (d / "qpos" / "000001.txt"), (d / "qpos" / "000002.txt")
    a, b = q1.read_text(), q2.read_text()
    q1.write_text(b)
    q2.write_text(a)
    return d


def test_diagnose_matches_jax(diag_data, tmp_path, monkeypatch, capsys):
    from easyhec_torch.cli import diagnose as td
    from easyhec_tpu.cli import diagnose as jd

    monkeypatch.chdir(ROOT)
    for name in ("easyhec_tpu", "easyhec_torch"):  # no handler of an earlier test
        monkeypatch.setattr(logging.getLogger(name), "handlers", [])
    args = ["-c", SIM, "--steps", "20", "--repair", "--robust", "0.3"]
    opts = [f"model.H={H}", f"model.W={W}", f"dataset.data_dir={diag_data}"]
    assert jd.main([*args, "--out", str(tmp_path / "j"), *opts]) == 0
    assert td.main([*args, "--out", str(tmp_path / "t"), "--device", "cpu", *opts]) == 0
    capsys.readouterr()
    rj = json.loads((tmp_path / "j" / "report.json").read_text())
    rt = json.loads((tmp_path / "t" / "report.json").read_text())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        ["overlays.png", "report.json", "report.md"]
    assert rt.keys() == rj.keys() >= {"baseline", "robust", "cross_pair", "image_pairing",
                                      "repair"}
    for key in ("baseline", "robust", "repair"):
        assert rt[key].keys() == rj[key].keys()
    for key in ("baseline", "robust"):  # both from the dataset's GT
        a, b = rt[key], rj[key]
        np.testing.assert_allclose(a["loss_last"], b["loss_last"], rtol=1e-3, err_msg=key)
        np.testing.assert_allclose(a["mean_iou"], b["mean_iou"], atol=1e-3, err_msg=key)
        np.testing.assert_allclose(a["per_frame_iou"], b["per_frame_iou"], atol=1e-3,
                                   err_msg=key)
        np.testing.assert_allclose(a["dof"], b["dof"], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(rt["baseline"]["loss_first"], rj["baseline"]["loss_first"],
                               rtol=1e-3)
    np.testing.assert_allclose(rt["cross_pair"]["matrix"], rj["cross_pair"]["matrix"],
                               atol=2e-3)
    assert rt["cross_pair"]["best_match"] == rj["cross_pair"]["best_match"] == [0, 2, 1, 3]
    assert rt["image_pairing"] == rj["image_pairing"]
    assert rt["repair"]["assignment_mask_to_qpos"] == [0, 2, 1, 3]
    assert rt["repair"]["assignment_mask_to_qpos"] == rj["repair"]["assignment_mask_to_qpos"]
    assert rt["repair"]["mean_iou"] > rt["baseline"]["mean_iou"] + 0.3
    # The repair fit starts from each package's own baseline pose (~2e-5
    # apart), and 20 steps on the swapped frames' rough loss part them (4 %
    # in loss, 2e-4 in pose). From JAX's baseline pose, the port's fit on
    # the re-paired qposes lands on JAX's repair: the pose at atol 1e-4, the
    # final loss (a residual of ~4 px² after a start of ~120) at atol 1e-2.
    from easyhec_torch.config import load_config
    from easyhec_torch.data import load_calib_dataset
    from easyhec_torch.trainer import build_runtime

    cfg = load_config(SIM, opts)
    trt = build_runtime(cfg, device="cpu")
    batch = load_calib_dataset(diag_data, trt.chain, trt.link_names)
    perm = rj["repair"]["assignment_mask_to_qpos"]
    fit = td._fit(trt, cfg, batch.link_poses[perm], batch.K, batch.masks,
                  np.asarray(rj["baseline"]["dof"], np.float32), steps=20)
    np.testing.assert_allclose(fit.losses[-1], rj["repair"]["loss_last"], atol=1e-2)
    np.testing.assert_allclose(fit.dof, rj["repair"]["dof"], atol=1e-4)
    np.testing.assert_allclose(rt["repair"]["dof"], rj["repair"]["dof"], atol=5e-4)
    np.testing.assert_allclose(rt["repair"]["mean_iou"], rj["repair"]["mean_iou"], atol=1e-2)
    for k in ("n_frames", "downscale", "H", "W"):
        assert rt[k] == rj[k]
    md = (tmp_path / "t" / "report.md").read_text()
    assert "Pairing repair" in md and "Cross-pair analysis" in md


def test_optimal_assignment_greedy_fallback(monkeypatch):
    import sys

    from easyhec_torch.cli.diagnose import _optimal_assignment

    cross = np.random.default_rng(0).random((5, 5)).astype(np.float32) * 0.3
    cross[[0, 1, 2, 3, 4], [3, 0, 4, 1, 2]] += 0.7
    want = [3, 0, 4, 1, 2]
    assert _optimal_assignment(cross).tolist() == want
    monkeypatch.setitem(sys.modules, "scipy.optimize", None)  # no scipy: greedy
    assert _optimal_assignment(cross).tolist() == want


# ---------------------------------------------------------------------------
# find_lr


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_find_lr_quadratic_matches_jax(optimizer):
    c = np.asarray([1.0, -2.0, 0.5], np.float32)
    kw = dict(start_lr=1e-5, end_lr=10.0, num_steps=80, optimizer=optimizer)
    rj = j_find_lr(lambda x: jnp.sum((x - c) ** 2), jnp.zeros(3), **kw)
    ct = torch.from_numpy(c)
    rt = t_find_lr(lambda x: torch.sum((x - ct) ** 2), torch.zeros(3), **kw)
    np.testing.assert_allclose(rt.lrs, rj.lrs, rtol=1e-6)
    assert rt.diverged_at == rj.diverged_at
    n = rj.diverged_at
    np.testing.assert_allclose(rt.losses[:n], rj.losses[:n], rtol=1e-5)
    np.testing.assert_allclose(rt.smoothed[:n], rj.smoothed[:n], rtol=1e-5)
    np.testing.assert_allclose(rt.suggestion, rj.suggestion, rtol=1e-6)
    if optimizer == "sgd":  # JAX's own test's expectations
        assert 1e-4 < rt.suggestion < 1.01 and rt.diverged_at < 80


def test_find_lr_params_containers():
    c = torch.tensor([1.0, -2.0])
    res = {}
    for name, p0, fn in (
        ("tensor", torch.zeros(2), lambda p: torch.sum((p - c) ** 2)),
        ("list", [torch.zeros(1), torch.zeros(1)],
         lambda p: (p[0] - c[0]) ** 2 + (p[1] - c[1]) ** 2),
        ("dict", {"a": torch.zeros(1), "b": torch.zeros(1)},
         lambda p: (p["a"] - c[0]) ** 2 + (p["b"] - c[1]) ** 2),
    ):
        res[name] = t_find_lr(lambda p: fn(p).sum(), p0, 1e-4, 1.0, 30, optimizer="adam")
    for name in ("list", "dict"):
        np.testing.assert_allclose(res[name].losses, res["tensor"].losses, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_find_lr(lambda p: p.sum(), torch.zeros(1), optimizer="lion")


def test_find_lr_calibration_loss_matches_jax(mini_rig):
    from easyhec_torch.models.calib import mask_loss as t_mask_loss
    from easyhec_torch.render import RobotRenderer as TR
    from easyhec_tpu.data.synthetic import default_camera
    from easyhec_tpu.geometry import se3 as jse3
    from easyhec_tpu.models.calib import mask_loss as j_mask_loss
    from easyhec_tpu.render import RobotRenderer as JR

    chain, jr0, link_idx = mini_rig
    h, w = 24, 32
    jr = JR(jr0.meshes, h, w, mode="brute")
    tr = TR(jr0.meshes, h, w, mode="brute", device="cpu")
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    qs = jnp.asarray([[0.2, -0.3], [-0.4, 0.5]], jnp.float32)
    lp = np.array(jax.vmap(chain.fk)(qs)[:, link_idx])
    gt = np.asarray(jse3.log(jnp.asarray(default_camera(), jnp.float32)))
    masks = np.array(jr.silhouette(jse3.exp(jnp.asarray(gt)), jnp.asarray(lp),
                                     jnp.asarray(K)) > 0.5, np.float32)
    d0 = gt + np.array([0.02, -0.01, 0.02, 0.01, 0.02, -0.02], np.float32)
    kw = dict(start_lr=1e-5, end_lr=1e-2, num_steps=20)
    rj = j_find_lr(lambda d: j_mask_loss(d, jr, jnp.asarray(lp), jnp.asarray(K),
                                         jnp.asarray(masks)), jnp.asarray(d0), **kw)
    lpt, Kt, mt = (torch.from_numpy(a) for a in (lp, K, masks))
    rt = t_find_lr(lambda d: t_mask_loss(d, tr, lpt, Kt, mt), torch.from_numpy(d0), **kw)
    assert np.isfinite(rj.losses).all() and rj.losses[0] > 1.0
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-4)
    assert rt.diverged_at == rj.diverged_at
    np.testing.assert_allclose(rt.suggestion, rj.suggestion, rtol=1e-6)


# ---------------------------------------------------------------------------
# profiling probes and the live server


def test_profiling_probes_match(tmp_path):
    kw = dict(n_pixels=10 * 480 * 640, n_triangles=21312, capacity=1664)
    peaks = dict(peak_flops=5e13, peak_bw=2e12)
    assert tprof.raster_roofline(**kw, **peaks) == jprof.raster_roofline(**kw, **peaks)
    h100 = tprof.raster_roofline(**kw)
    assert h100 == jprof.raster_roofline(**kw, peak_flops=67e12, peak_bw=3.35e12)
    marks = {}
    for name, mod, x in (("t", tprof, torch.ones(3)), ("j", jprof, jnp.ones(3))):
        t = mod.EvalTimer()
        t("start")
        t("a", sync=x * 2)
        t("b")
        t("a")
        off = mod.EvalTimer(enabled=False)
        off("start")
        off("a")
        assert off.summary() == {}
        marks[name] = {k: len(v) for k, v in t.marks.items()}
        assert all(v >= 0 for v in t.summary().values())
    assert marks["t"] == marks["j"] == {"a": 2, "b": 1}
    with tprof.trace(tmp_path / "tr"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "tr" / tprof.TRACE_NAME).read_text()
    assert "traceEvents" in text and "aten::mm" in text
    with tprof.trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_matches_jax(tmp_path):
    from easyhec_torch.utils import live as tlive
    from easyhec_torch.utils.logging import MetricsWriter
    from easyhec_tpu.utils import live as jlive

    run = tmp_path / "run"
    w = MetricsWriter(run)
    for s in range(5):
        w.scalars(s, mask_loss=1.0 / (s + 1))
    (run / "images").mkdir(exist_ok=True)
    for name in ("panel_000003.png", "rendered_000010.png"):
        (run / "images" / name).write_bytes(b"")
    w.close()
    got = {}
    for name, mod in (("t", tlive), ("j", jlive)):
        page = mod.write_dashboard(run)
        port = _free_port()
        srv = mod.serve(run, port=port, background=True)
        try:
            base = f"http://127.0.0.1:{port}"
            ls = json.loads(urllib.request.urlopen(f"{base}/api/ls", timeout=5).read())
            html = urllib.request.urlopen(f"{base}/{page.name}", timeout=5).read()
            lines = urllib.request.urlopen(f"{base}/metrics.jsonl", timeout=5).read()
        finally:
            srv.shutdown()
            srv.server_close()
        got[name] = (ls, len(lines.decode().strip().splitlines()))
        assert b"metrics.jsonl" in html
    assert got["t"] == got["j"] == (["panel_000003.png", "rendered_000010.png"], 5)


def test_watch_cli_serves(tmp_path, monkeypatch, capsys):
    from easyhec_torch.cli import watch
    from easyhec_torch.utils import live as tlive

    calls = []
    monkeypatch.setattr(tlive, "serve", lambda d, port: calls.append((d, port)))
    assert watch.main([str(tmp_path / "run"), "--port", "8123"]) == 0
    assert calls == [(str(tmp_path / "run"), 8123)]
    assert (tmp_path / "run" / tlive.DASHBOARD_NAME).exists()
    assert "http://localhost:8123/live.html" in capsys.readouterr().out
