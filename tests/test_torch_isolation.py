"""easyhec_torch stands alone: no module of it (nor chip_smoke.py) imports
jax, optax, easyhec_tpu or __graft_entry__, and its entry points refuse to
fall back to the CPU when the caller did not ask for it. The GPU machine has
no PyYAML, OpenCV, PIL or matplotlib either: every module imports without
them, config files are read with the port's own YAML reader, and the others
are needed only for OpenCV's GrabCut and window and formats other than PNG.
"""
import importlib
import json
import pkgutil
import re
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
# kernel-free render options, with perception and the remaining tools, and
# with multi-device, and the YAML reader.
NEW_MODULES = (
    "easyhec_torch.config.yaml_lite",
    "easyhec_torch.parallel",
    "easyhec_torch.parallel.comm",
    "easyhec_torch.parallel.distributed",
    "easyhec_torch.parallel.sharding",
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
from easyhec_torch.config import Config, apply_overrides, load_config, save_config
cfg = Config()
out = Path(tempfile.mkdtemp()) / "config.yaml"
save_config(cfg, out)
assert json.loads(out.read_text())["render"]["compact_chunks"] == 0
# a config file, its overrides and the run's config.yaml, read with no PyYAML
cfg = load_config({str(ROOT / "configs" / "franka_online.yaml")!r},
                  ["model.H=720", "render.fused=off", "model.use_links=[a, b]"])
assert cfg.model.init_method == "manual" and cfg.model.init_Tc_c2b[3] == [0.0, 0.0, 0.0, 1.0]
assert (cfg.model.H, cfg.render.fused, cfg.model.use_links) == (720, False, ["a", "b"])
apply_overrides(cfg, ["solver.max_lr=3e-3", "output_dir='runs/x: #1'"])
assert cfg.solver.max_lr == "3e-3" and cfg.output_dir == "runs/x: #1"
save_config(cfg, out)
assert load_config(out) == cfg
import numpy as np
from easyhec_torch.utils.imaging import read_png, write_png
img = (np.arange(48 * 64 * 3) % 251).astype(np.uint8).reshape(48, 64, 3)
write_png(out.parent / "x.png", img)
assert (read_png(out.parent / "x.png") == img).all()
print(json.dumps(names))
"""


def test_no_module_imports_yaml():
    """The port reads YAML with its own config/yaml_lite.py on every machine."""
    pkg = ROOT / "easyhec_torch"
    found = [str(p.relative_to(ROOT)) for p in pkg.rglob("*.py")
             if re.search(r"^\s*(import yaml|from yaml\b)", p.read_text(), re.M)]
    assert found == []


def test_new_modules_import_without_host_packages():
    r = subprocess.run([sys.executable, "-c", _HOST_PROBE], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    names = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert set(NEW_MODULES) <= names


_EXPORTS_PROBE = f"""
import importlib, json, sys, tempfile
from pathlib import Path
for k in {BLOCKED + ("yaml", "cv2", "matplotlib", "PIL")!r}:
    sys.modules[k] = None  # any import of it now raises ImportError
sys.path.insert(0, {str(ROOT)!r})
from easyhec_torch.models import (CalibResult, ExploreResult, LinkSpheres, SpaceExplorer,
                                  build_link_spheres, calibrate, mask_loss, pose_metrics,
                                  render_outputs)
from easyhec_torch.solver import make_optimizer, make_schedule
from easyhec_torch.render import (Triangles2D, bin_triangles, depth_bruteforce, depth_tiled,
                                  setup_triangles, silhouette_bruteforce, silhouette_tiled,
                                  transform_verts)
from easyhec_torch.geometry import (from_rt, inverse, matrix_3x4_to_4x4, se3_exp, se3_log,
                                    so3_exp, so3_log, transform_points)
out = {{}}
for pkg in ("geometry", "models", "render", "solver", "parallel", "utils", "trainer", "data"):
    m = importlib.import_module("easyhec_torch." + pkg)
    out[pkg] = [n for n in m.__all__ if getattr(m, n, None) is not None]
import numpy as np
from easyhec_torch.utils.logging import MetricsWriter
d = Path(tempfile.mkdtemp())
w = MetricsWriter(d)
w.image(3, "error_map", np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4))
w.close()
out["images"] = sorted(p.name for p in (d / "images").iterdir())
print(json.dumps(out))
"""


def test_package_exports_import_without_host_packages():
    """The package exports (JAX's names) resolve, and an image panel is
    written, with JAX, matplotlib, OpenCV, PyYAML and PIL all blocked."""
    r = subprocess.run([sys.executable, "-c", _EXPORTS_PROBE], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out.pop("images") == ["error_map_000003.png"]
    for pkg, names in out.items():
        assert names == list(importlib.import_module("easyhec_torch." + pkg).__all__), pkg
    assert "calibrate" in out["models"] and "make_optimizer" in out["solver"]
    assert {"silhouette_tiled", "Triangles2D"} <= set(out["render"])
    assert "transform_points" in out["geometry"]


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
