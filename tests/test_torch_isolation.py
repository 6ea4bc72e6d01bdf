"""easyhec_torch stands alone: no module of it (nor chip_smoke.py) imports
jax, optax, easyhec_tpu or __graft_entry__, and its entry points refuse to
fall back to the CPU when the caller did not ask for it. The GPU machine has
no PyYAML, OpenCV, PIL or matplotlib either: every module imports without
them, and they are needed only to read config files, OpenCV's GrabCut and
window, and formats other than PNG.
"""
import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import easyhec_torch
from easyhec_torch.robot import make_box
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "optax", "easyhec_tpu", "__graft_entry__")

_PROBE = f"""
import importlib, pkgutil, sys
blocked = {BLOCKED!r}
for k in list(sys.modules):
    if k.split(".")[0] in blocked:
        del sys.modules[k]
for k in blocked:
    sys.modules[k] = None  # any import of it now raises ImportError
sys.path.insert(0, {str(ROOT)!r})
import easyhec_torch
names = [m.name for m in pkgutil.walk_packages(easyhec_torch.__path__, "easyhec_torch.")]
for n in names:
    importlib.import_module(n)
importlib.import_module("chip_smoke")
leaked = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in blocked]
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    expected = len(list(pkgutil.walk_packages(easyhec_torch.__path__, "easyhec_torch.")))
    assert int(r.stdout.strip()) == expected >= 20


# Modules added with the dense route and the offline trainer, with the
# unfused route (K5), the global search, the tiled depth pass and the
# simulator, with the online loop, with the offline tools and the
# kernel-free render options, and with perception and the remaining tools.
NEW_MODULES = (
    "easyhec_torch.cli.annotate",
    "easyhec_torch.cli.diagnose",
    "easyhec_torch.cli.train_segmenter",
    "easyhec_torch.cli.watch",
    "easyhec_torch.convert",
    "easyhec_torch.io.annotate",
    "easyhec_torch.models.segmentation",
    "easyhec_torch.solver.lr_finder",
    "easyhec_torch.utils.profiling",
    "easyhec_torch.cli.tune_init",
    "easyhec_torch.cli.validate",
    "easyhec_torch.data.batching",
    "easyhec_torch.data.transforms",
    "easyhec_torch.render.raster_jnp",
    "easyhec_torch.utils.arrays",
    "easyhec_torch.utils.runfiles",
    "easyhec_torch.visualizers",
    "easyhec_torch.visualizers.visualizers",
    "easyhec_torch.io",
    "easyhec_torch.io.interfaces",
    "easyhec_torch.io.native_planner",
    "easyhec_torch.io.planner",
    "easyhec_torch.io.workspace",
    "easyhec_torch.models.explorer",
    "easyhec_torch.trainer.iterative",
    "easyhec_torch.utils.imaging",
    "easyhec_torch.utils.scene3d",
    "easyhec_torch.cli.run",
    "easyhec_torch.cli.simulate",
    "easyhec_torch.data.synthetic",
    "easyhec_torch.ops.tile_raster",
    "easyhec_torch.render.raster_core",
    "easyhec_torch.config.config",
    "easyhec_torch.data.dataset",
    "easyhec_torch.evaluators.evaluators",
    "easyhec_torch.models.pose_init",
    "easyhec_torch.registry",
    "easyhec_torch.trainer.offline",
    "easyhec_torch.utils.checkpoint",
    "easyhec_torch.utils.live",
    "easyhec_torch.utils.logging",
)

_HOST_PROBE = f"""
import importlib, json, pkgutil, sys, tempfile
from pathlib import Path
for k in {BLOCKED + ("yaml", "cv2", "matplotlib", "PIL")!r}:
    sys.modules[k] = None  # any import of it now raises ImportError
sys.path.insert(0, {str(ROOT)!r})
import easyhec_torch
names = [m.name for m in pkgutil.walk_packages(easyhec_torch.__path__, "easyhec_torch.")]
for n in names:
    importlib.import_module(n)
from easyhec_torch.config import Config, save_config
cfg = Config()
out = Path(tempfile.mkdtemp()) / "config.yaml"
save_config(cfg, out)
assert json.loads(out.read_text())["render"]["compact_chunks"] == 0
import numpy as np
from easyhec_torch.utils.imaging import read_png, write_png
img = (np.arange(48 * 64 * 3) % 251).astype(np.uint8).reshape(48, 64, 3)
write_png(out.parent / "x.png", img)
assert (read_png(out.parent / "x.png") == img).all()
print(json.dumps(names))
"""


def test_new_modules_import_without_host_packages():
    r = subprocess.run([sys.executable, "-c", _HOST_PROBE], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    names = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert set(NEW_MODULES) <= names


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from easyhec_torch.render import RobotRenderer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        RobotRenderer([make_box()], 8, 8)
    with pytest.raises(RuntimeError):
        easyhec_torch.resolve_device()
    assert easyhec_torch.resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    # in the checkout: no CUDA -> non-zero exit, no result line
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    # alone in a directory: non-zero exit as well
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
