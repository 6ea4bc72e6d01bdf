"""Port parity: easyhec_torch.models.explorer (and the simulated camera, the
workspace cloud and the PNG writer it feeds) against easyhec_tpu on the
CPU, on the mini arm (MINI_URDF) at 48×64.

The JAX explorer draws its hypotheses and candidates from jax.random,
which torch cannot reproduce: where a test needs identical draws it
replaces the port's ``draw_hypotheses_and_candidates`` by ``jax_draws``
(the JAX explorer's own two draws). Tolerances: the variance sums the same
coverage terms in another order, so it is held to 1e-4 of its largest
value; feasibility, the argmax and the escalated tile configuration must
be equal; the sphere fits and the workspace cloud are numpy copies and must
be bit-identical; the simulated capture is held to 1e-5 and its PNG files
must decode (cv2) to the JAX package's pixels.
"""
import tempfile

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.io import interfaces as tif
from easyhec_torch.io.workspace import workspace_boundary_points as t_ws
from easyhec_torch.models import explorer as tex
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.robot import build_chain as t_build_chain
from easyhec_torch.robot import load_link_meshes as t_load_link_meshes
from easyhec_torch.robot import parse_urdf as t_parse_urdf
from easyhec_torch.utils.imaging import write_png
from easyhec_tpu.data.dataset import save_calib_frame as j_save_frame
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.io import interfaces as jif
from easyhec_tpu.io.workspace import workspace_boundary_points as j_ws
from easyhec_tpu.models import explorer as jex
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]
BASE = dict(tile_h=16, tile_w=32, capacity=256, binner="count", margin=2.0,
            bin_big_k=128, bwd_band_only=True)
ROUTES = {
    "compact": dict(BASE, fused=True, compact_chunks=16),
    "dense": dict(BASE, fused=True),
    "counted": dict(BASE),
    "topk": dict(BASE, binner="topk"),  # no bin state: one batched render
}


def jax_draws(key, n_hypotheses, n_hist, n_sample, lo, hi):
    """The JAX explorer's draws (easyhec_tpu/models/explorer.py:394-410)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    sel = jax.random.randint(k1, (n_hypotheses,), 0, n_hist)
    q = jax.random.uniform(k2, (n_sample, len(lo)), minval=jnp.asarray(lo),
                           maxval=jnp.asarray(hi))
    return np.asarray(sel), np.asarray(q)


@pytest.fixture(scope="module")
def rig():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    jmodel, tmodel = parse_urdf(path), t_parse_urdf(path)
    jchain, tchain = build_chain(jmodel), t_build_chain(tmodel)
    jmeshes = load_link_meshes(jmodel, link_names=LINKS)
    tmeshes = t_load_link_meshes(tmodel, link_names=LINKS)
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    gt = np.asarray(jse3.log(jnp.asarray(Tc)))
    history = (gt[None] + np.random.default_rng(0).normal(0, 0.02, (30, 6))).astype(np.float32)
    return dict(jchain=jchain, tchain=tchain, jmeshes=jmeshes, tmeshes=tmeshes, Tc=Tc,
                history=history)


def _explorers(rig, route, **kw):
    jr = JR([rig["jmeshes"][n] for n in LINKS], H, W, tile=JTC(**ROUTES[route]))
    tr = TR([rig["tmeshes"][n] for n in LINKS], H, W, tile=TTC(**ROUTES[route]),
            device="cpu")
    return (jex.SpaceExplorer(rig["jchain"], jr, LINKS, **kw),
            tex.SpaceExplorer(rig["tchain"], tr, LINKS, **kw))


def test_link_spheres_and_workspace_bit_exact(rig):
    js = jex.build_link_spheres(rig["jchain"], rig["jmeshes"])
    ts = tex.build_link_spheres(rig["tchain"], rig["tmeshes"])
    for f in ("centers", "radii", "pair_mask", "link_indices"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    for kw in ({}, dict(table_z=0.05, n_box=500, n_table=200, seed=3)):
        np.testing.assert_array_equal(t_ws(**kw), j_ws(**kw))


def test_gates_equal_on_64_candidates(rig):
    js = jex.build_link_spheres(rig["jchain"], rig["jmeshes"])
    ts = tex.build_link_spheres(rig["tchain"], rig["tmeshes"])
    lim = rig["tchain"].joint_limits
    q = np.random.default_rng(1).uniform(lim[:, 0], lim[:, 1], (64, 2)).astype(np.float32)
    # a margin and a workspace radius at which both gates split the candidates
    kw = dict(max_dist=0.37, collision_margin=0.2)
    je = jex.SpaceExplorer(rig["jchain"], None, LINKS, spheres=js, **kw)
    te = tex.SpaceExplorer(rig["tchain"], None, LINKS, spheres=ts, **kw)
    jp = jax.vmap(rig["jchain"].fk)(jnp.asarray(q))
    tp = rig["tchain"].fk(torch.from_numpy(q))
    for gate in ("_self_collision_free", "_within_workspace"):
        want = np.asarray(getattr(je, gate)(jp))
        got = getattr(te, gate)(tp).numpy()
        np.testing.assert_array_equal(got, want, err_msg=gate)
        assert 0 < want.sum() < len(want), (gate, want.sum())


def test_hypothesis_spread_px(rig):
    je, te = _explorers(rig, "compact")
    hyp = rig["history"][::7]
    want = je.hypothesis_spread_px(hyp, K)
    assert want > 1.0
    assert abs(te.hypothesis_spread_px(hyp, K) - want) <= 1e-4
    np.testing.assert_allclose(te._probe_points(), je._probe_points(), atol=1e-6)


@pytest.mark.parametrize("route,shared", [
    (route, shared) for route in ROUTES for shared in (False, True)
    if not (route == "topk" and shared)  # the top-k binner has no shared path
])
def test_score_matches_jax(rig, route, shared):
    """7 candidates in batches of 3 (the last one padded) × 3 hypotheses."""
    je, te = _explorers(rig, route, score_batch=3, max_dist=0.37)
    lim = rig["tchain"].joint_limits
    q = np.random.default_rng(2).uniform(lim[:, 0], lim[:, 1], (7, 2)).astype(np.float32)
    hyp = rig["history"][[0, 11, 23]]
    vj, fj, oj = (np.asarray(a) for a in je._score(jnp.asarray(q), jnp.asarray(hyp),
                                                     jnp.asarray(K), shared=shared))
    vt, ft, ot = (a.numpy() for a in te._score(q, hyp, K, shared=shared))
    np.testing.assert_array_equal(ft, fj)
    assert 0 < fj.sum() < len(fj)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(np.isfinite(vt), fin)
    assert np.abs(vj[fin]).max() > 1.0
    np.testing.assert_allclose(vt[fin], vj[fin], atol=1e-4 * np.abs(vj[fin]).max())
    assert np.argmax(vt) == np.argmax(vj)
    assert bool(ot) == bool(oj) is False
    assert te.last_bin_states == (0 if route == "topk" else 3 if shared else 9)


def test_overflow_escalation_and_identical_hypotheses(rig, monkeypatch):
    """From cap 16 the escalation doubles the budgets and the rect window to
    the same TileConfig as JAX's; with identical draws both explorers then
    pick the same qpos, and identical hypotheses give zero variance."""
    monkeypatch.setattr(tex, "draw_hypotheses_and_candidates", jax_draws)
    tiny = dict(ROUTES["counted"], capacity=16, rect_y=1, rect_x=1)
    jr = JR([rig["jmeshes"][n] for n in LINKS], H, W, tile=JTC(**tiny))
    tr = TR([rig["tmeshes"][n] for n in LINKS], H, W, tile=TTC(**tiny), device="cpu")
    kw = dict(spheres=None, n_sample_qposes=8, n_hypotheses=3, history_start=0,
              max_dist=None)
    je = jex.SpaceExplorer(rig["jchain"], jr, LINKS, **kw)
    te = tex.SpaceExplorer(rig["tchain"], tr, LINKS, **kw)
    rj = je.explore(rig["history"], K, key=0)
    rt = te.explore(rig["history"], K, key=0)
    assert te.last_escalations >= 1 and te.renderer.tile.capacity > 16
    assert tuple(te.renderer.tile) == tuple(je.renderer.tile)
    assert te.renderer.device.type == "cpu" and te.renderer.mode == "tiled"
    np.testing.assert_array_equal(rt.qpos_all, rj.qpos_all)
    np.testing.assert_array_equal(rt.qpos, rj.qpos)
    np.testing.assert_allclose(rt.var_all, rj.var_all, atol=1e-4 * np.abs(rj.var_all).max())
    same = np.repeat(rig["history"][:1], 20, axis=0)
    assert abs(te.explore(same, K, key=1).variance) < 1e-6


def test_draws_are_seeded_and_in_range(rig):
    lim = rig["tchain"].joint_limits * np.float32(0.9)
    a = tex.draw_hypotheses_and_candidates(3, 10, 7, 100, lim[:, 0], lim[:, 1])
    b = tex.draw_hypotheses_and_candidates(3, 10, 7, 100, lim[:, 0], lim[:, 1])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].min() >= 0 and a[0].max() < 7 and a[1].dtype == np.float32
    assert (a[1] >= lim[:, 0]).all() and (a[1] < lim[:, 1]).all()


@pytest.mark.parametrize("route", ["compact", "counted"])
def test_sim_camera_capture(rig, route):
    jr = JR([rig["jmeshes"][n] for n in LINKS], H, W, tile=JTC(**ROUTES[route]))
    tr = TR([rig["tmeshes"][n] for n in LINKS], H, W, tile=TTC(**ROUTES[route]),
            device="cpu")
    ja, ta = jif.SimArm(2), tif.SimArm(2)
    jc = jif.SimCamera(jr, rig["jchain"], LINKS, rig["Tc"], K, ja)
    tc = tif.SimCamera(tr, rig["tchain"], LINKS, rig["Tc"], K, ta)
    for q in ([0.0, 0.0], [0.4, -0.7]):
        ja.move_to(np.asarray(q)), ta.move_to(np.asarray(q))
        mj = np.asarray(jc._render(jnp.asarray(ja.get_qpos())))
        mt = tc._render(ta.get_qpos())
        assert mj.mean() > 0.005
        np.testing.assert_allclose(mt, mj, atol=1e-5)
        (rgb_j, kj), (rgb_t, kt) = jc.capture(), tc.capture()
        np.testing.assert_array_equal(kt, kj)
        assert (np.abs(rgb_t.astype(int) - rgb_j.astype(int)) > 1).mean() <= 1e-3


def test_png_writer_decodes_to_jax_files(tmp_path):
    from easyhec_torch.data.dataset import save_calib_frame as t_save_frame

    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    mask = (rng.random((37, 53)) > 0.7).astype(np.float32)
    q = np.array([0.1, -0.2], np.float32)
    j_save_frame(tmp_path / "j", 3, rgb, mask, q)
    t_save_frame(tmp_path / "t", 3, rgb, mask, q)
    for sub in ("color", "mask"):
        jimg = cv2.imread(str(tmp_path / "j" / sub / "000003.png"), cv2.IMREAD_UNCHANGED)
        timg = cv2.imread(str(tmp_path / "t" / sub / "000003.png"), cv2.IMREAD_UNCHANGED)
        assert timg is not None and timg.dtype == np.uint8
        np.testing.assert_array_equal(timg, jimg, err_msg=sub)
    assert (tmp_path / "t" / "qpos" / "000003.txt").read_text() == \
        (tmp_path / "j" / "qpos" / "000003.txt").read_text()
    write_png(tmp_path / "g.png", rgb[..., 1])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED),
                                  rgb[..., 1])
    with pytest.raises(TypeError):
        write_png(tmp_path / "f.png", mask)
