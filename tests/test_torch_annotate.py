"""Port parity: prompt annotation (io/annotate.py, cli/annotate.py) against
easyhec_tpu's on the CPU.

Every case of tests/test_annotate.py runs through both packages and the
two masks must be equal (the code is numpy and, for the GrabCut backend,
the same OpenCV call). Connected components (scipy's 4-connected labels in
the port, OpenCV's in the reference) must give the same partition. The one
divergence, the negative-box clamp, is shown. Both packages' cli/annotate
(--auto with a flax-layout weights pickle, --auto with --box/--point, and
the GrabCut --box mode) write the same mask PNGs, except where the U-Net's
logit lies within 1e-4 of 0 (the two forwards differ by ~2e-5 in f32).
"""
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from easyhec_torch.io import annotate as tann
from easyhec_tpu.io import annotate as jann
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

MODS = {"jax": jann, "torch": tann}


def _scene():
    """Synthetic scene: bright square object on dark background."""
    rng = np.random.default_rng(0)
    rgb = (rng.normal(30, 5, (64, 64, 3))).clip(0, 255).astype(np.uint8)
    rgb[20:44, 24:48] = rng.normal(200, 10, (24, 24, 3)).clip(0, 255)
    gt = np.zeros((64, 64), np.float32)
    gt[20:44, 24:48] = 1
    return rgb, gt


class _Fake:
    def __init__(self, mask):
        self.mask = mask

    def predict(self, rgb):
        return self.mask.copy()


class _Prob:
    def __init__(self, regions):
        self.regions = regions

    def predict(self, rgb):
        return (self.predict_prob(rgb) > 0.5).astype("float32")

    def predict_prob(self, rgb):
        prob = np.zeros(rgb.shape[:2], np.float32)
        for (y0, y1, x0, x1), p in self.regions:
            prob[y0:y1, x0:x1] = p
        return prob


def _both(fn):
    """fn(module) in both packages; the results must be equal."""
    out = {k: fn(m) for k, m in MODS.items()}
    np.testing.assert_array_equal(out["torch"], out["jax"])
    return out["torch"]


def test_grabcut_box_prompt():
    rgb, gt = _scene()

    def run(m):
        p = m.Prompts()
        p.add_box(18, 16, 52, 48)
        return m.PromptMasker().predict(rgb, p)

    mask = _both(run)
    assert ((mask > 0.5) & (gt > 0.5)).sum() / ((mask > 0.5) | (gt > 0.5)).sum() > 0.7


def test_negative_point_removes_component():
    rgb, _ = _scene()
    rgb[4:10, 4:10] = 210

    def run(m):
        p = m.Prompts()
        p.add_box(0, 0, 63, 63)
        p.add_point(6, 6, label=0)
        return m.PromptMasker().predict(rgb, p)

    mask = _both(run)
    assert mask[6, 6] < 0.5 and mask[30, 36] > 0.5


def test_model_backend_with_box_gate():
    rgb, gt = _scene()

    def run(m):
        p = m.Prompts()
        p.add_box(0, 0, 35, 63)
        return m.PromptMasker(backend=_Fake(gt)).predict(rgb, p)

    mask = _both(run)
    assert mask[:, :36].sum() > 0 and mask[:, 36:].sum() == 0


@pytest.mark.parametrize("hysteresis", [0.2, 0.4])
def test_model_backend_hysteresis_click(hysteresis):
    rgb, _ = _scene()
    model = _Prob([((10, 30, 5, 25), 0.9), ((35, 50, 5, 25), 0.35)])

    def run(m):
        masker = m.PromptMasker(backend=model, hysteresis=hysteresis)
        p = m.Prompts()
        p.add_point(10, 40, 1)
        return np.stack([masker.predict(rgb, m.Prompts()), masker.predict(rgb, p)])

    base, mask = _both(run)
    assert base[40, 10] == 0 and mask[10 - 5, 40] == 0
    assert mask[40, 10] == (1 if hysteresis == 0.2 else 0)


def test_model_backend_negative_click_bounded_by_confidence():
    rgb, _ = _scene()
    model = _Prob([((10, 30, 5, 25), 0.95), ((10, 30, 25, 40), 0.6)])

    def run(m):
        out = []
        for x in (30, 10):  # in the weak attached strip, then on the confident region
            p = m.Prompts()
            p.add_point(x, 20, 0)
            out.append(m.PromptMasker(backend=model).predict(rgb, p))
        return np.stack(out)

    weak, strong = _both(run)
    assert weak[20, 10] == 1 and weak[20, 30] == 0 and strong[20, 10] == 0


def test_prompts_undo_reset():
    for m in MODS.values():
        p = m.Prompts()
        p.add_box(5, 5, 0, 0)
        p.add_box(1, 1, 3, 3, label=0)
        p.add_point(1, 1, 1)
        assert p.boxes == [(0, 0, 5, 5)] and p.neg_boxes == [(1, 1, 3, 3)]
        p.undo()
        assert not p.points and len(p.neg_boxes) == 1
        p.undo()
        p.undo()
        assert not p.boxes and not p.neg_boxes
        p.add_point(2, 2, 0)
        p.reset()
        assert not p.points and not p.labels


def test_annotation_session_incremental():
    rgb, _ = _scene()

    def run(m):
        s = m.AnnotationSession(rgb)
        assert s.stats()["area_px"] == 0
        m1 = s.add_box(10, 10, 60, 50)
        yx = np.argwhere(m1 > 0.5)[0]
        m2 = s.add_point(int(yx[1]), int(yx[0]), 0)
        m3 = s.undo()
        st = s.stats()
        prev = s.ascii_preview(width=32)
        ov = s.overlay()
        s.reset()
        assert s.stats()["area_px"] == 0 and s.stats()["n_prompts"] == 0
        assert (m2 > 0.5).sum() < (m1 > 0.5).sum() == (m3 > 0.5).sum()
        assert "#" in prev or "+" in prev
        return np.stack([m1, m2, m3]), st, prev, ov

    (mt, st, pt, ot), (mj, sj, pj, oj) = run(tann), run(jann)
    np.testing.assert_array_equal(mt, mj)
    assert st == sj and pt == pj
    np.testing.assert_array_equal(ot, oj)


def test_annotate_repl_scripted(tmp_path):
    rgb, _ = _scene()
    cmds = ["help", "box 10 10 60 50", "show", "bogus", "box 1 2", "undo",
            "box 10 10 60 50", "pos 30 30", "neg 2 2", "reset", "box 10 10 60 50", "accept"]
    out = {}
    for name, m in MODS.items():
        it, log = iter(cmds), []
        mask = m.annotate_repl(rgb, input_fn=lambda *_: next(it), echo=log.append,
                               overlay_path=str(tmp_path / f"{name}.png"))
        assert mask is not None and (mask > 0.5).sum() > 0
        assert any("unknown command" in str(x) for x in log)
        out[name] = (mask, [str(x).replace(f"{name}.png", "overlay.png") for x in log])
        assert m.annotate_repl(rgb, input_fn=lambda *_: "skip", echo=lambda *_: None) is None
        assert m.annotate_repl(rgb, input_fn=lambda *_: next(iter(())),
                               echo=lambda *_: None) is None
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "torch.png")),
                                  cv2.imread(str(tmp_path / "jax.png")))


@pytest.mark.parametrize("seed", range(4))
def test_connected_components_partition_matches_opencv(seed):
    rng = np.random.default_rng(seed)
    b = rng.random((40, 50)) > (0.3 + 0.1 * seed)
    ours = tann._connected_components(b)
    n, ref = cv2.connectedComponents(b.astype(np.uint8), connectivity=4)
    assert ours.max() == n - 1 > 3
    assert ((ours == 0) == (ref == 0)).all()
    pairs = np.unique(np.stack([ours[b], ref[b]]), axis=1)
    assert pairs.shape[1] == n - 1  # a bijection between the labels


def test_negative_box_clamp_divergence():
    """The reference clamps only a negative box's lower slice bounds, so a
    box wholly above or left of the image (x1 or y1 < 0) wraps the slice's
    end and zeroes almost the whole mask; the port removes nothing there.
    Boxes that reach into the image agree."""
    mask = np.ones((20, 30), np.float32)
    off = tann.Prompts()
    off.add_box(-10, -8, -4, -2, label=0)
    assert tann.PromptMasker._apply_neg_boxes(mask, off).sum() == mask.sum()
    # the reference: the slice [0:-1, 0:-3] zeroes all but the last row and 3 columns
    assert jann.PromptMasker._apply_neg_boxes(mask, off).sum() == mask.size - 19 * 27
    for box in [(-5, -5, 9, 4), (3, 4, 10, 12), (25, 15, 40, 30)]:
        p_t, p_j = tann.Prompts(), jann.Prompts()
        p_t.add_box(*box, label=0)
        p_j.add_box(*box, label=0)
        np.testing.assert_array_equal(tann.PromptMasker._apply_neg_boxes(mask, p_t),
                                      jann.PromptMasker._apply_neg_boxes(mask, p_j))


@pytest.fixture(scope="module")
def capture_dir(tmp_path_factory):
    """color/*.png written by PIL (adaptive filters) and a flax-layout U-Net
    pickle (base 16, flax's initialization) saved by JAX's save_params."""
    from easyhec_tpu.models.segmentation import UNet, save_params

    root = tmp_path_factory.mktemp("annot")
    (root / "data" / "color").mkdir(parents=True)
    rng = np.random.default_rng(2)
    for i in range(3):
        rgb = rng.normal(40, 10, (32, 48, 3)).clip(0, 255).astype(np.uint8)
        rgb[6 + i:26, 12:34] = 200
        Image.fromarray(rgb).save(root / "data" / "color" / f"{i:06d}.png", optimize=True)
    params = jax.jit(UNet(base=16).init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 48, 3)))
    save_params(root / "seg.pkl", params)
    return root


@pytest.mark.parametrize("mode", ["auto", "auto_prompts", "grabcut"])
def test_cli_annotate_matches_jax(capture_dir, tmp_path, mode, capsys):
    from easyhec_torch.cli import annotate as tcli
    from easyhec_torch.models.segmentation import SegmenterMaskSource, load_params
    from easyhec_tpu.cli import annotate as jcli

    w = ["--auto", "--weights", str(capture_dir / "seg.pkl")]
    prompts = ["--box", "8", "4", "40", "30", "--point", "20", "15", "1", "--point", "2", "2", "0"]
    extra = {"auto": w, "auto_prompts": w + prompts, "grabcut": prompts[:5]}[mode]
    masks = {}
    for name, mod, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(capture_dir / "data", d)
        assert mod.main(["--data-dir", str(d), *extra, *dev]) == 0
        assert capsys.readouterr().out.strip() == f"wrote 3 masks to {d / 'mask'}"
        masks[name] = [cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
                       for p in sorted((d / "mask").glob("*.png"))]
        # a second run without --overwrite skips every frame
        assert mod.main(["--data-dir", str(d), *extra, *dev]) == 0
        assert "wrote 0 masks" in capsys.readouterr().out
    src = SegmenterMaskSource(load_params(capture_dir / "seg.pkl"), device="cpu")
    assert len(masks["t"]) == len(masks["j"]) == 3
    for i, (a, b) in enumerate(zip(masks["t"], masks["j"])):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (32, 48)
        rgb = np.asarray(Image.open(capture_dir / "data" / "color" / f"{i:06d}.png"))
        prob = src.predict_prob(rgb)
        band = np.abs(np.log(prob) - np.log1p(-prob)) < 1e-4
        assert not ((a != b) & ~band).any()
        assert 0 < (a > 0).sum()
