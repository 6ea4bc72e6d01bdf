"""Port parity: the U-Net segmenter and cli/train_segmenter against
easyhec_tpu's flax ones on the CPU.

- The forward pass with converted weights (base 8) at 32×48 and at the odd
  45×30, where the nearest upsampling must sample as jax.image.resize does:
  logits atol 1e-4 (GroupNorm's variance by another formula and the convs'
  summation order; measured ~2e-5 of logits up to ~2.5). The flax <-> torch
  weight conversion round-trips exactly.
- ``cli/train_segmenter`` in both packages at 32×48 on sim_mini, 2 ring
  cameras × 3 frames, 5 steps, with JAX's qpos draws, initial weights and
  batch/jitter draws fed to the port: the same report keys and split, the
  same mask and colour PNGs (at most 1e-3 of the pixels differ: the two
  rasterizers agree to ~1e-5 before the 0.5 threshold and 8-bit rounding),
  the loss trace rtol 1e-3 and the trained logits within 5 % of how far the
  5 steps moved them. Why no tighter: Adam's first steps are ±lr for every
  weight whatever the gradient's size, so weights whose gradient sits near
  roundoff (torch's CPU GroupNorm backward sums in another order, ~1e-4 of
  the largest gradient; flax's conv-bias reduction in the head is off by
  0.6 % against float64) step in either direction in either package; the
  loss trace and the logits show the training agrees, a weight-by-weight
  comparison would only show that noise.
- The weights cross both ways: JAX's pickle drives the port's
  SegmenterMaskSource and the port's drives JAX's: probabilities atol 1e-5,
  masks equal except where the logit lies within 1e-4 of 0.
- ``--eval-dir``/``--eval-overlays`` on a PIL-written capture dir (the
  port reads it with read_png).
"""
import contextlib
import io
import json
import logging
import os
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from easyhec_torch.convert import unet_state_from_flax, unet_state_to_flax
from easyhec_torch.models import segmentation as tseg
from easyhec_tpu.models import segmentation as jseg
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SIM = str(ROOT / "configs" / "sim_mini.yaml")
H, W = 32, 48
STEPS = 5


def jax_draws(seed, steps, n, batch_size):
    """JAX's train_segmenter draws, in draw_training_batches' layout."""
    key = jax.random.PRNGKey(seed)
    idx, scale, shift = [], [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        idx.append(np.asarray(jax.random.randint(k1, (batch_size,), 0, n)))
        scale.append(np.asarray(1.0 + 0.3 * jax.random.normal(k2, (batch_size, 1, 1, 1))))
        shift.append(np.asarray(0.1 * jax.random.normal(k3, (batch_size, 1, 1, 1))))
    return (torch.from_numpy(np.stack(idx)).long(),
            torch.from_numpy(np.stack(scale).reshape(steps, batch_size)),
            torch.from_numpy(np.stack(shift).reshape(steps, batch_size)))


def _eval_dir(root: Path) -> Path:
    """A 2-frame reference-format capture dir written by PIL."""
    d = root / "eval"
    for sub in ("color", "mask", "qpos"):
        (d / sub).mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(2):
        rgb = rng.integers(0, 60, (H, W, 3)).astype(np.uint8)
        rgb[8 + i:24, 10:30] = 190
        m = np.zeros((H, W), np.uint8)
        m[8 + i:24, 10:30] = 255
        Image.fromarray(rgb).save(d / "color" / f"{i:06d}.png", optimize=True)
        Image.fromarray(m, "L").save(d / "mask" / f"{i:06d}.png")
        np.savetxt(d / "qpos" / f"{i:06d}.txt", np.zeros(2))
    np.savetxt(d / "K.txt", np.array([[57.6, 0, W / 2], [0, 57.6, H / 2], [0, 0, 1]]))
    return d


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both packages' train_segmenter CLI on the same sim_mini rig, the port
    fed JAX's draws; each run's report, loss trace and output dir."""
    from easyhec_torch.cli import train_segmenter as t_cli
    from easyhec_torch.data import synthetic as tsyn
    from easyhec_tpu.cli import train_segmenter as j_cli
    from easyhec_tpu.data import synthetic as jsyn

    root = tmp_path_factory.mktemp("segcli")
    ev = _eval_dir(root)
    args = ["-c", SIM, "--n-cams", "2", "--frames-per-cam", "3", "--steps", str(STEPS),
            "--eval-dir", str(ev)]
    opts = [f"model.H={H}", f"model.W={W}"]
    out, traces = {}, {"j": [], "t": []}
    j_init = jax.tree.map(np.asarray, jax.jit(jseg.UNet(base=16).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32)))
    real_jit, real_bce = jax.jit, tseg._bce_loss

    def recording_jit(fn, *a, **kw):  # JAX's training step: record its loss
        f = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "step":
            return f

        def g(*args):
            res = f(*args)
            traces["j"].append(float(res[2]))
            return res

        return g

    def recording_bce(logits, targets):
        loss = real_bce(logits, targets)
        traces["t"].append(loss.item())
        return loss

    def jax_qposes(gen, chain, n, limit_fraction=0.5):
        key = jax.random.PRNGKey(gen.initial_seed())
        return torch.from_numpy(np.array(jsyn.sample_qposes(key, chain, n, limit_fraction)))

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name in ("easyhec_tpu", "easyhec_torch"):
                mp.setattr(logging.getLogger(name), "handlers", [])
            mp.setattr(jseg.jax, "jit", recording_jit)
            mp.setattr(tsyn, "sample_qposes", jax_qposes)
            mp.setattr(tseg, "draw_training_batches", jax_draws)
            mp.setattr(tseg, "_flax_init",
                       lambda model, g: model.load_state_dict(unet_state_from_flax(j_init)))
            mp.setattr(tseg, "_bce_loss", recording_bce)
            for name, mod, extra in (("j", j_cli, []), ("t", t_cli, ["--device", "cpu"])):
                d = root / name
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert mod.main([*args, "--out", str(d / "seg.pkl"), "--data-out",
                                     str(d / "data"), "--eval-overlays", str(d / "ov"),
                                     *extra, *opts]) == 0
                out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        os.chdir(cwd)
    return root, out, traces, j_init


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("h,w", [(32, 48), (45, 30)])
def test_unet_forward_matches_flax(h, w):
    net = jseg.UNet(base=8)
    p = jax.tree.map(np.asarray, jax.jit(net.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, h, w, 3), jnp.float32)))
    x = np.random.default_rng(h).random((2, h, w, 3)).astype(np.float32)
    lj = np.asarray(jax.jit(net.apply)(p, x))
    m = tseg.UNet(8)
    m.load_state_dict(unet_state_from_flax(p))
    with torch.no_grad():
        lt = m(torch.from_numpy(x)).numpy()
    assert lt.shape == lj.shape == (2, h, w) and np.abs(lj).max() > 0.5
    np.testing.assert_allclose(lt, lj, atol=1e-4)
    back = unet_state_to_flax(m.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    assert sum(t.numel() for t in tseg.UNet(16).parameters()) == 118913


def test_train_segmenter_cli_matches_jax(cli_runs):
    root, out, traces, _ = cli_runs
    rj, rt = out["j"], out["t"]
    assert rt.keys() == rj.keys() >= {"final_loss", "val_iou_mean", "real_eval"}
    assert (rt["train_frames"], rt["val_frames"]) == (rj["train_frames"], rj["val_frames"]) == (5, 1)
    assert _files(root / "t") == _files(root / "j")
    for f in _files(root / "j" / "data"):
        if f.endswith(".png"):
            a, b = (cv2.imread(str(root / p / "data" / f), cv2.IMREAD_UNCHANGED) for p in "tj")
            assert (a != b).mean() <= 1e-3, f
    assert len(traces["t"]) == len(traces["j"]) == STEPS
    np.testing.assert_allclose(traces["t"], traces["j"], rtol=1e-3)
    np.testing.assert_allclose(rt["final_loss"], rj["final_loss"], rtol=1e-3)
    np.testing.assert_allclose(rt["val_iou_mean"], rj["val_iou_mean"], atol=2e-2)
    assert rt["real_eval"].keys() == rj["real_eval"].keys()
    np.testing.assert_allclose(rt["real_eval"]["per_frame_iou"],
                               rj["real_eval"]["per_frame_iou"], atol=2e-2)


def test_trained_logits_match_jax(cli_runs):
    root, _, _, j_init = cli_runs
    x = np.stack([cv2.imread(str(p))[..., ::-1] for p in
                  sorted((root / "j" / "data" / "cam00" / "color").glob("*.png"))])
    x = x.astype(np.float32) / 255.0
    logits = {}
    for name, params in (("init", j_init), ("j", tseg.load_params(root / "j" / "seg.pkl")),
                         ("t", tseg.load_params(root / "t" / "seg.pkl"))):
        m = tseg.UNet(16)
        m.load_state_dict(unet_state_from_flax(params))
        with torch.no_grad():
            logits[name] = m(torch.from_numpy(x)).numpy()
    moved = np.abs(logits["j"] - logits["init"]).max()
    assert moved > 0.1
    assert np.abs(logits["t"] - logits["j"]).max() <= 0.05 * moved


def _ambiguous(prob):
    logit = np.log(prob) - np.log1p(-prob)
    return np.abs(logit) < 1e-4


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_weights_cross_packages(cli_runs, writer):
    root, _, _, _ = cli_runs
    path = root / ("j" if writer == "jax" else "t") / "seg.pkl"
    frames = [np.asarray(Image.open(p).convert("RGB")) for p in
              sorted((root / "j" / "data" / "cam01" / "color").glob("*.png"))]
    js = jseg.SegmenterMaskSource(jseg.load_params(path))
    ts = tseg.SegmenterMaskSource(tseg.load_params(path), device="cpu")
    for f in frames:
        pj, pt = js.predict_prob(f), ts.predict_prob(f)
        np.testing.assert_allclose(pt, pj, atol=1e-5)
        differ = js.predict(f) != ts.predict(f)
        assert not (differ & ~_ambiguous(pj)).any()
        np.testing.assert_array_equal(ts.predict(f), (pt > 0.5).astype(np.float32))


def test_save_load_params_roundtrip(tmp_path):
    state = {k: v.clone() for k, v in tseg.UNet(8).state_dict().items()}
    tseg.save_params(tmp_path / "a" / "w.pkl", state)
    tree = tseg.load_params(tmp_path / "a" / "w.pkl")
    assert set(tree) == {"params"} and "_ConvBlock_4" in tree["params"]
    back = unet_state_from_flax(tree)
    assert back.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)
    tseg.save_params(tmp_path / "b.pkl", tree)  # a flax tree is written as it is
    assert (tmp_path / "b.pkl").read_bytes() == (tmp_path / "a" / "w.pkl").read_bytes()
    src = tseg.SegmenterMaskSource(tree, base=8, threshold=0.7, device="cpu")
    rgb = np.random.default_rng(0).integers(0, 255, (16, 24, 3)).astype(np.uint8)
    prob = src.predict_prob(rgb)
    assert prob.shape == (16, 24) and ((prob >= 0) & (prob <= 1)).all()
    np.testing.assert_array_equal(src.predict(rgb), (prob > 0.7).astype(np.float32))


def test_flax_init_statistics():
    m = tseg.UNet(16)
    tseg._flax_init(m, torch.Generator().manual_seed(0))
    w = m.blocks[3].conv0.weight  # fan_in 9·96
    std = (1.0 / (9 * 96)) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert all((blk.conv0.bias == 0).all() and (blk.gn0.weight == 1).all() for blk in m.blocks)
