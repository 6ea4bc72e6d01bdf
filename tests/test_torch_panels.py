"""The port's image panels against the JAX package's: MetricsWriter.image
(``plt.imsave`` in JAX, ``utils.imaging.colorize`` + ``write_png`` in the
port) on the same arrays, RGB channels equal value for value; the port's
hot table against matplotlib's; and the TensorBoard option.

The panel comparisons need matplotlib (JAX's writer and the colormap
tables) and skip where it is absent.
"""
import logging
import sys

import numpy as np
import pytest

from easyhec_torch.utils import imaging as timg
from easyhec_torch.utils.imaging import read_png
from easyhec_torch.utils.logging import MetricsWriter as TWriter
from easyhec_tpu.utils.logging import MetricsWriter as JWriter
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "map": rng.normal(0.5, 0.4, (37, 53)).astype(np.float32),  # clipped at 0 and 1
        "map_f64": rng.random((20, 30)),
        "zeros": np.zeros((16, 24), np.float32),
        "batched": rng.random((1, 1, 12, 18)).astype(np.float32),  # JAX's reshape branch
        "u8_map": rng.integers(3, 200, (15, 21)).astype(np.uint8),
        "u8_rgb": rng.integers(0, 256, (15, 21, 3)).astype(np.uint8),
        "rgb": rng.normal(0.5, 0.5, (14, 10, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_panel_matches_jax_imsave(tmp_path, name):
    pytest.importorskip("matplotlib")
    arr = _arrays()[name]
    for writer, d in ((JWriter, tmp_path / "jax"), (TWriter, tmp_path / "torch")):
        w = writer(d)
        w.image(7, "error_map", arr)
        w.close()
    j = read_png(tmp_path / "jax" / "images" / "error_map_000007.png")
    t = read_png(tmp_path / "torch" / "images" / "error_map_000007.png")
    assert j.shape[:2] == t.shape[:2] and t.shape[2] == 3 and t.dtype == np.uint8
    np.testing.assert_array_equal(t, j[..., :3])


def test_colormap_tables_match_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    for name, table in (("viridis", timg._VIRIDIS), ("hot", timg._HOT),
                        ("gray", timg._GRAY)):
        ref = (matplotlib.colormaps[name](np.arange(256))[:, :3] * 255).astype(np.uint8)
        np.testing.assert_array_equal(table, ref)
    x = np.linspace(0, 1, 300, dtype=np.float32)[None]
    ref = matplotlib.colormaps["gray"](matplotlib.colors.Normalize()(x), bytes=True)
    np.testing.assert_array_equal(timg.colorize(x, "gray"), ref[..., :3])


def test_panel_refuses_other_3d(tmp_path):
    """A 3-D array that is not RGB(A) raises (JAX's imsave raises too, and
    its writer swallows the error: it writes nothing)."""
    w = TWriter(tmp_path)
    with pytest.raises(ValueError, match="3 or 4 channels"):
        w.image(1, "rendered", np.zeros((2, 5, 6), np.float32))
    w.close()


def test_tensorboard_option(tmp_path, monkeypatch, caplog):
    """tensorboard=True writes event files under tb/; where TensorBoard
    cannot be imported, one warning and the JSONL and PNGs as without it."""
    pytest.importorskip("tensorboard")
    w = TWriter(tmp_path / "on", tensorboard=True)
    w.scalars(1, mask_loss=0.5)
    w.image(1, "rendered", np.zeros((4, 6), np.float32))
    w.close()
    assert any((tmp_path / "on" / "tb").iterdir())
    assert (tmp_path / "on" / "images" / "rendered_000001.png").exists()

    for k in [k for k in sys.modules if k.startswith("torch.utils.tensorboard")]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "tensorboard", None)  # import raises
    with caplog.at_level(logging.WARNING, logger="easyhec_torch"):
        logging.getLogger("easyhec_torch").propagate = True
        try:
            w = TWriter(tmp_path / "off", tensorboard=True)
        finally:
            logging.getLogger("easyhec_torch").propagate = False
    w.scalars(2, mask_loss=0.25)
    w.image(2, "rendered", np.zeros((4, 6), np.float32))
    w.close()
    assert sum("TensorBoard" in r.message for r in caplog.records) == 1
    assert not (tmp_path / "off" / "tb").exists()
    assert (tmp_path / "off" / "metrics.jsonl").read_text().count("mask_loss") == 1
    assert (tmp_path / "off" / "images" / "rendered_000002.png").exists()
