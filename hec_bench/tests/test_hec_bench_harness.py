"""CPU rehearsal of the benchmark harness (python -m pytest hec_bench/tests).

Each cell runs end to end at a tiny size and prints a well-formed last
line; a workload file dropped into hec_bench/workloads/ runs with no code
change; no module imports JAX or the JAX package, and the reference
imports nothing of the program; the roofline counts depend on the inputs
alone; the control and the planted faults come out not correct, the sound
program correct. Tests that need the card skip here.
"""
from __future__ import annotations

import ast
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hec_bench import harness as hb
from hec_bench import scene
from hec_bench.roofline import work
from hec_bench.tests import tiny

HERE = Path(hb.__file__).resolve().parent
CELLS = [m["name"] for m in hb.manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a benchmark run refuses to start without one)")
    return torch.device("cuda")


def _line_ok(d: dict, wl_name: str) -> None:
    assert set(d) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(d)[-1] == "checks"
    man = hb.manifest()
    want = {m["name"] for m in hb.metrics_for(man, wl_name, "end_to_end")}
    assert set(d["metrics"]) == want
    for m in d["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in d["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_tiny_and_prints_its_line(name):
    rc, d, err = tiny.run_tiny(name)
    assert rc == 0
    _line_ok(d, name)
    assert d["correct"] is True, err
    assert d["attempted"] >= 1 and d["failed"] == 0
    assert "check " in err.strip().splitlines()[-1]


def test_a_dropped_workload_file_runs_without_code_change():
    name = "xarm7-720p.calib-dropped"
    path = HERE / "workloads" / f"{name}.json"
    src = json.loads((HERE / "workloads" / "xarm7-720p.calib.json").read_text())
    src["params"]["offset"] = 0.05
    man = copy.deepcopy(hb.manifest())
    man["workloads"].append({"name": name, "config": "xarm7-720p", "traffic": "calib",
                             "chips": 1, "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "xarm7-720p.calib" in m.get("workloads", []):
            m["workloads"].append(name)
    path.write_text(json.dumps(src))
    try:
        wl, cfg = tiny.cell_and_config(name)
        assert wl["params"]["offset"] == 0.05
        rc, d, _ = tiny.run_tiny(name, man=man, wl=wl, cfg=cfg)
    finally:
        path.unlink()
    assert rc == 0
    _line_ok(d, "xarm7-720p.calib")
    assert d["correct"] is True


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = _imports(path) & set(hb.JAX_NAMES)
        assert not bad, f"{path}: imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "easyhec_torch" not in _imports(path), path
    for path in (HERE / "roofline").rglob("*.py"):
        assert "easyhec_torch" not in _imports(path), path


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "jaxtyping_stub", object())
    monkeypatch.setitem(sys.modules, "easyhec_tpu_extra", object())
    assert hb.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "easyhec_tpu.render", object())
    assert hb.jax_loaded() == ["easyhec_tpu.render"]


def test_roofline_counts_depend_on_the_inputs_only():
    cfg = hb.config("xarm7-720p")
    cfg.update(H=180, W=320, f=226.7)
    other = copy.deepcopy(cfg)
    other["render"].update(tile_h=8, tile_w=128, capacity=64, compact_chunks=7, bin_big_k=1,
                           rect_y=1, rect_x=1)
    s = scene.capture_set(cfg, scene.arm(cfg), scene.ref_scene(
        cfg, scene.arm(cfg), scene.geo.intrinsics(cfg["H"], cfg["W"], cfg["f"])),
        scene.rng(5, 1), 3)
    Tc, lp = torch.as_tensor(s["Tc"]), torch.as_tensor(s["lp"])
    counts = []
    for c in (cfg, other):
        a = scene.arm(c)
        sc = scene.ref_scene(c, a, scene.geo.intrinsics(c["H"], c["W"], c["f"]))
        counts.append((work.loss_work(sc, Tc, lp), work.silhouette_work(sc, Tc, lp)))
    assert counts[0] == counts[1]
    (nb, ops), _ = counts[0]
    assert nb > 4 * 3 * 180 * 320 and ops > 0


def test_scene_meshes_equal_the_programs_loader():
    """The benchmark makes the arm itself; the program's own loader, handed
    the same URDF, gives the same triangles (the inputs are shared, not the
    program's)."""
    from easyhec_torch.robot import load_link_meshes, parse_urdf
    from easyhec_torch.robot.mesh import subdivide_to_max_edge

    cfg = hb.config("xarm7-720p")
    a = scene.arm(cfg)
    model = parse_urdf(HERE / cfg["arm"]["urdf"])
    raw = load_link_meshes(model, link_names=a.names)
    for n in a.names:
        m = subdivide_to_max_edge(raw[n], cfg["arm"]["max_edge"])
        np.testing.assert_array_equal(a.meshes[n][0], m.vertices)
        np.testing.assert_array_equal(a.meshes[n][1], m.faces)
        np.testing.assert_array_equal(a.raw[n][0], raw[n].vertices)
    c, _ = a.corners()
    assert len(c) == 21312


def test_reference_fk_and_twist_match_the_programs():
    from easyhec_torch.geometry import se3
    from easyhec_torch.robot import build_chain, parse_urdf

    cfg = hb.config("xarm7-720p")
    a = scene.arm(cfg)
    chain = build_chain(parse_urdf(HERE / cfg["arm"]["urdf"]))
    q = scene.qposes(a, scene.rng(3, 0), 8, 0.9)
    ours = scene.geo.fk(a.robot, q, a.names)
    theirs = chain.fk(torch.as_tensor(q))[:, [chain.link_index(n) for n in a.names]]
    np.testing.assert_allclose(ours, theirs.numpy(), atol=2e-6)
    xi = np.array([0.1, -0.2, 0.3, 0.4, -0.5, 0.25])
    np.testing.assert_allclose(scene.geo.se3_exp(torch.as_tensor(xi)).numpy(),
                               se3.exp(torch.as_tensor(xi, dtype=torch.float32)).numpy(), atol=2e-6)
    T = scene.camera(cfg, scene.rng(4, 1))
    np.testing.assert_allclose(scene.geo.se3_exp(torch.as_tensor(scene.geo.se3_log_np(T))).numpy(),
                               T, atol=1e-12)


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    from hec_bench import run as R

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "xarm7-720p.calib", "--seed", str(2**31 + 9), "--seconds", "1",
                 "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_cells_run_on_the_card(card):
    """On the card: the command itself, one short run of each cell."""
    import subprocess
    import sys

    for name in CELLS:
        out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", name,
                              "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, cwd=HERE.parent, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        d = json.loads(out.stdout.strip().splitlines()[-1])
        _line_ok(d, name)
        assert d["correct"] is True
