"""Port parity: the offline tools and host-side helpers against easyhec_tpu's
on the CPU.

- ``utils/arrays``, ``utils/runfiles``, ``data/batching``,
  ``data/transforms``: exact equality, with the same numpy generators;
- ``camera.ring_poses`` at atol 1e-6; ``generate_pose_dataset`` on the mini
  arm at 48×64: poses atol 1e-6, masks atol 1e-4, the same files, the
  decoded PNGs equal but for at most 1e-3 of the pixels;
- ``cli/validate`` after a 10-step run on a simulate dataset (sim_mini,
  120×160, 3 frames): the same report.json (IoU 1e-4, pose 1e-4) and the
  same files; ``cli/tune_init``'s printed JSON and pose within
  test_init_dof_global_search_matches_jax's atol 1e-4 (its small search),
  and the look-at path's pose at 1e-5.
"""
import functools
import json
import logging
import os
import random
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.data import batching as tb
from easyhec_torch.data import transforms as tt
from easyhec_torch.geometry import camera as tcam
from easyhec_torch.utils import arrays as ta
from easyhec_torch.utils import runfiles as trf
from easyhec_tpu.data import batching as jb
from easyhec_tpu.data import transforms as jt
from easyhec_tpu.geometry import camera as jcam
from easyhec_tpu.utils import arrays as ja
from easyhec_tpu.utils import runfiles as jrf

from test_torch_trainer import SIM, SMALL_SEARCH, sim_data  # noqa: F401  (module fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


# ---------------------------------------------------------------------------
# host-side helpers


def test_arrays_match():
    x = np.random.default_rng(0).normal(size=(7, 3)).astype(np.float32)
    for mod in (ta, ja):
        assert mod.min_max(x) == (float(x.min()), float(x.max()))
    np.testing.assert_array_equal(ta.to_array(torch.from_numpy(x)), ja.to_array(x))
    assert ta.ptp(torch.from_numpy(x)) == ja.ptp(x)
    np.testing.assert_array_equal(ta.norm(x), ja.norm(x))
    for n, rep in ((3, False), (9, False), (4, True)):
        (vt, it), (vj, ij) = (m.random_choice(x, n, rep, rng=np.random.default_rng(1))
                              for m in (ta, ja))
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(it, ij)
    parts = [x[:2], x[:5, :2], np.ones((1, 3), np.float32)]
    for a, b in zip(ta.padded_stack(parts, -1.0), ja.padded_stack(parts, -1.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta.stack_or_list([x, x]), ja.stack_or_list([x, x]))
    assert len(ta.stack_or_list(parts)) == 3
    with pytest.raises(ValueError):
        ta.padded_stack([x, x[0]])


def test_runfiles_match(tmp_path):
    for name, mod in (("t", trf), ("j", jrf)):
        out = tmp_path / name
        (out / "sub").mkdir(parents=True)
        (out / "a.txt").write_text("a")
        (out / "sub" / "b.txt").write_text("b")
        dst = mod.archive_runs(out)
        assert dst.parent == out / "archive"
        assert mod.archive_runs(out) is None  # nothing left but the archive
    assert [p.relative_to(tmp_path / "t").parts[2:] for p in sorted((tmp_path / "t").rglob("*.txt"))] \
        == [p.relative_to(tmp_path / "j").parts[2:] for p in sorted((tmp_path / "j").rglob("*.txt"))]
    snap = trf.make_source_snapshot(tmp_path / "snap")
    assert snap.name == "easyhec_torch" and (snap / "utils" / "runfiles.py").exists()
    g = trf.deterministic_seed(5)
    draws_t = (random.random(), np.random.rand(3), torch.rand(2, generator=g))
    jrf.deterministic_seed(5)
    draws_j = (random.random(), np.random.rand(3))
    assert draws_t[0] == draws_j[0]
    np.testing.assert_array_equal(draws_t[1], draws_j[1])
    np.testing.assert_array_equal(draws_t[2].numpy(),
                                  torch.rand(2, generator=torch.Generator().manual_seed(5)).numpy())


def test_batching_matches():
    rng = np.random.default_rng(2)
    items = [{"img": rng.random((4, 5 + i)).astype(np.float32), "k": np.float32(i),
              "name": f"f{i}", "box": rng.random((i + 1, 4))} for i in range(3)]
    same = [dict(it, img=it["img"][:, :5], box=it["box"][:1]) for it in items]
    for a, b in ((tb.default_collate(same), jb.default_collate(same)),
                 (tb.padded_collate(items, -1.0), jb.padded_collate(items, -1.0))):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k]
    batches = [[0, 1], [2, 3], [4]]
    for t_s, j_s in (
        (tb.IterationBasedBatchSampler(batches, 7, start_iter=1),
         jb.IterationBasedBatchSampler(batches, 7, start_iter=1)),
        (tb.ImageSizeBatchSampler(range(11), 3, drop_last=False, seed=4),
         jb.ImageSizeBatchSampler(range(11), 3, drop_last=False, seed=4)),
        (tb.OrderedShardSampler(10, 2, 3), jb.OrderedShardSampler(10, 2, 3)),
    ):
        assert list(t_s) == list(j_s) and len(t_s) == len(j_s)
    with pytest.raises(ValueError):
        tb.OrderedShardSampler(4, 3, 3)


def test_transforms_match():
    rng = np.random.default_rng(3)
    img = (rng.random((30, 44, 3)) * 255).astype(np.uint8)
    mask = (rng.random((30, 44)) > 0.5).astype(np.float32)
    K = np.array([[50.0, 0, 22], [0, 50.0, 15], [0, 0, 1]], np.float32)

    def pipeline(mod, seed):
        g = np.random.default_rng(seed)
        return mod.Compose([
            mod.ToFloat(), mod.RandomHorizontalFlip(0.5, rng=g),
            mod.ColorJitter(0.3, 0.3, 0.3, rng=g), mod.Resize(20, 40),
            mod.CenterCrop(24, 16), mod.Normalize([0.5] * 3, [0.25] * 3),
            mod.ClipRange((-1.5, 1.5)),
        ])

    for seed in range(4):
        it, mt, at = pipeline(tt, seed)(img, mask, K=K)
        ij, mj, aj = pipeline(jt, seed)(img, mask, K=K)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(at["K"], aj["K"])
    specs = [{"name": "center_crop", "width": 20, "height": 10},
             {"name": "clip_range", "range": [0.1, 0.9]}]
    a, b = tt.build_transforms(specs)(img / 255.0), jt.build_transforms(specs)(img / 255.0)
    np.testing.assert_array_equal(a[0], b[0])
    assert repr(tt.build_transforms(specs)).startswith("Compose(")


# ---------------------------------------------------------------------------
# the ring of views and the pose dataset


@pytest.mark.parametrize("n,radius,height,target,start", [
    (8, 1.5, 0.8, None, 0.0), (5, 0.9, 0.4, (0.1, -0.2, 0.25), 0.3)])
def test_ring_poses_match(n, radius, height, target, start):
    pj = np.asarray(jcam.ring_poses(n, radius, height, None if target is None
                                    else jnp.asarray(target, jnp.float32), start_angle=start))
    pt = tcam.ring_poses(n, radius, height, None if target is None
                         else torch.tensor(target, dtype=torch.float32), start_angle=start)
    assert pt.shape == (n, 4, 4)
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-6)


def test_generate_pose_dataset_matches_jax(tmp_path, mini_rig):
    from easyhec_torch.data.synthetic import generate_pose_dataset as t_gen
    from easyhec_torch.render import RobotRenderer as TR
    from easyhec_torch.render import TileConfig as TTC
    from easyhec_torch.robot import build_chain as t_chain
    from easyhec_torch.robot import parse_urdf as t_parse
    from easyhec_tpu.data.synthetic import generate_pose_dataset as j_gen

    jchain, jr, _ = mini_rig
    urdf = tmp_path / "mini_arm.urdf"
    urdf.write_text(MINI_URDF)
    tchain = t_chain(t_parse(urdf))
    tr = TR(jr.meshes, jr.H, jr.W, tile=TTC(*jr.tile), device="cpu")
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    kw = dict(n_views=4, radius=1.0, height=0.6, target=(0.0, 0.0, 0.25), seed=3,
              jitter=0.01, qpos=np.array([0.3, -0.4], np.float32))
    links = ["base", "upper", "fore"]
    oj = j_gen(tmp_path / "j", jchain, jr, links, K, **kw)
    ot = t_gen(tmp_path / "t", tchain, tr, links, K, **kw)
    np.testing.assert_allclose(ot["poses"], oj["poses"], atol=1e-6)
    assert oj["masks"].mean() > 0.01
    np.testing.assert_allclose(ot["masks"], oj["masks"], atol=1e-4)
    np.testing.assert_allclose(ot["diameter"], oj["diameter"], rtol=1e-6)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for i in range(4):
        for sub in ("color", "mask"):
            a, b = (cv2.imread(str(tmp_path / p / sub / f"{i:06d}.png"), cv2.IMREAD_UNCHANGED)
                    for p in ("t", "j"))
            assert (a != b).mean() <= 1e-3
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "pose" / f"{i:06d}.txt"),
                                   np.loadtxt(tmp_path / "j" / "pose" / f"{i:06d}.txt"),
                                   atol=1e-6)
    for name in ("K.txt", "qpos.txt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    pj, pt = (np.array((tmp_path / p / "model.ply").read_text().split("end_header\n")[1].split(),
                       np.float64) for p in ("j", "t"))
    np.testing.assert_allclose(pt, pj, atol=1e-5)


# ---------------------------------------------------------------------------
# validate and tune_init on a simulate dataset


@pytest.fixture(scope="module")
def trained(sim_data, tmp_path_factory):  # noqa: F811
    """A 10-step port run of sim_mini on the simulate dataset (its final
    checkpoint is what both validators read)."""
    from easyhec_torch.config import load_config as t_load
    from easyhec_torch.trainer import run_offline_calibration

    d, opts = sim_data
    out = tmp_path_factory.mktemp("trained")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        run_offline_calibration(t_load(SIM, opts + [f"output_dir={out}"]), device="cpu")
    finally:
        os.chdir(cwd)
    return opts + [f"output_dir={out}"], out


def test_validate_matches_jax(trained, tmp_path, monkeypatch, capsys):
    from easyhec_torch.cli import validate as tv
    from easyhec_tpu.cli import validate as jv

    monkeypatch.chdir(ROOT)
    for name in ("easyhec_tpu", "easyhec_torch"):  # no handler of an earlier test
        monkeypatch.setattr(logging.getLogger(name), "handlers", [])
    opts, out = trained
    ckpt = str(out / "checkpoints" / "final.npz")
    assert jv.main(["-c", SIM, "--ckpt", ckpt, "--out", str(tmp_path / "j"), *opts]) == 0
    assert tv.main(["-c", SIM, "--ckpt", ckpt, "--out", str(tmp_path / "t"),
                    "--device", "cpu", *opts]) == 0
    capsys.readouterr()
    rj = json.loads((tmp_path / "j" / "report.json").read_text())
    rt = json.loads((tmp_path / "t" / "report.json").read_text())
    assert rt.keys() == rj.keys() and rt["checkpoint"] == rj["checkpoint"]
    np.testing.assert_allclose(rt["Tc_c2b"], rj["Tc_c2b"], atol=1e-4)
    assert [f["frame"] for f in rt["frames"]] == [0, 1, 2]
    np.testing.assert_allclose([f["iou"] for f in rt["frames"]],
                               [f["iou"] for f in rj["frames"]], atol=1e-4)
    np.testing.assert_allclose(rt["mean_iou"], rj["mean_iou"], atol=1e-4)
    assert rj["mean_iou"] > 0.5
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    # the default checkpoint is the newest under output_dir/checkpoints
    from easyhec_torch.config import load_config as t_load
    from easyhec_torch.utils.checkpoint import latest_checkpoint

    report = tv.validate(t_load(SIM, opts), out=tmp_path / "d", device="cpu")
    assert report["checkpoint"] == str(latest_checkpoint(out / "checkpoints"))


def _tune_json(text: str):
    lines = text.strip().splitlines()
    info = json.loads(lines[0])
    T = np.array([json.loads(line.strip()[2:]) for line in lines[-4:]])
    return info, T


@pytest.mark.parametrize("mode", ["lookat", "global_search"])
def test_tune_init_matches_jax(trained, tmp_path, monkeypatch, capsys, mode):
    from easyhec_torch.cli import tune_init as ttu
    from easyhec_torch.models import pose_init as tpi
    from easyhec_tpu.cli import tune_init as jtu
    from easyhec_tpu.models import pose_init as jpi

    monkeypatch.chdir(ROOT)
    for mod in (tpi, jpi):
        monkeypatch.setattr(mod, "global_search_init",
                            functools.partial(mod.global_search_init, **SMALL_SEARCH))
    opts, _ = trained
    if mode == "lookat":
        args = ["--eye", "1.2", "0.9", "0.8", "--target", "0", "0", "0.3",
                "--offset-xyz", "0.01", "0", "-0.02", "--offset-rpy", "0", "0.05", "0"]
        # The reference nudges lookat_init's pose in place, but that is a
        # read-only view of a jax array, so its look-at path raises; the
        # port's is writable. JAX's CLI runs here on a writable copy.
        with pytest.raises(ValueError, match="read-only"):
            jtu.main(["-c", SIM, *args, "--out", str(tmp_path / "x"), *opts])
        monkeypatch.setattr(jpi, "lookat_init",
                            lambda *a, real=jpi.lookat_init: np.array(real(*a)))
    else:
        args = ["--global-search"]
    outs = {}
    for name, mod, extra in (("j", jtu, []), ("t", ttu, ["--device", "cpu"])):
        assert mod.main(["-c", SIM, *args, "--frame", "1", "--out", str(tmp_path / name),
                         *extra, *opts]) == 0
        outs[name] = _tune_json(capsys.readouterr().out)
    (ij, Tj), (it, Tt) = outs["j"], outs["t"]
    assert it.keys() == ij.keys()
    np.testing.assert_allclose([it[k] for k in ij], [ij[k] for k in ij], atol=1e-4)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4 if mode == "global_search" else 1e-5)
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == ["tune_overlay.png"]
    if mode == "lookat":
        assert ij["overlay_iou"] > 0
