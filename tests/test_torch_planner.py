"""Port parity: easyhec_torch.io.planner and io.native_planner against
easyhec_tpu's on the CPU, on the mini arm (MINI_URDF).

The planners are numpy copies that draw from ``np.random.default_rng(seed)``
and run the collision model through the port's ``KinematicChain.fk_np``, so
every plan must equal the JAX package's bit for bit: waypoints, timing,
velocities and accelerations. The native planner (native/libezplan.so,
built from native/ezplan.cpp with make at first use) is held to the port's
Python planner as the JAX package's test holds it to JAX's.
"""
import tempfile

import numpy as np
import pytest

from __graft_entry__ import MINI_URDF
from easyhec_torch.io import native_planner as tnp
from easyhec_torch.io import planner as tpl
from easyhec_torch.io.workspace import workspace_boundary_points
from easyhec_torch.models.explorer import build_link_spheres as t_spheres
from easyhec_torch.robot import build_chain as t_build_chain
from easyhec_torch.robot import load_link_meshes as t_load_link_meshes
from easyhec_torch.robot import parse_urdf as t_parse_urdf
from easyhec_tpu.io import planner as jpl
from easyhec_tpu.models.explorer import build_link_spheres as j_spheres
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

LINKS = ["base", "upper", "fore"]


@pytest.fixture(scope="module")
def rig():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    jm, tm = parse_urdf(path), t_parse_urdf(path)
    jc, tc = build_chain(jm), t_build_chain(tm)
    js = j_spheres(jc, load_link_meshes(jm, link_names=LINKS))
    ts = t_spheres(tc, t_load_link_meshes(tm, link_names=LINKS))
    return jc, tc, js, ts


def _assert_same_plan(pt, pj):
    assert pt.keys() == pj.keys()
    for k in pj:
        if isinstance(pj[k], np.ndarray):
            assert pt[k].dtype == pj[k].dtype, k
            np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
        else:
            assert pt[k] == pj[k], k


def _wall(chain, q, n=20, reach=0.25, seed=0):
    """Obstacle points around the point `reach` along the last link's z axis
    at q (0.25: the forearm's tip; 0: its origin, the elbow)."""
    T = chain.fk_np(np.asarray(q, np.float32))[-1]
    p = T[:3, :3] @ np.array([0.0, 0.0, reach], np.float32) + T[:3, 3]
    return (p + np.random.default_rng(seed).normal(0, 0.01, (n, 3))).astype(np.float32)


# start, goal, obstacle: none, the workspace boundary, or a wall at the
# forearm's tip at a point of the straight path (the RRT goes around it)
CASES = [
    ([0.0, 0.0], [0.5, 0.3], None),
    ([0.0, 0.0], [-1.2, 1.5], "workspace"),
    ([-1.0, 0.0], [1.0, 0.0], [0.0, 0.0]),
    ([-0.5, 0.5], [0.5, 0.5], [0.2, 0.3]),
]


@pytest.mark.parametrize("q0,q1,obstacle", CASES)
def test_plan_to_qpos_bit_identical(rig, q0, q1, obstacle):
    jc, tc, js, ts = rig
    env = None
    if obstacle == "workspace":
        env = workspace_boundary_points(table_z=-0.5)
    elif obstacle is not None:
        env = _wall(tc, obstacle)
    for seed in (0, 1, 3):
        pj = jpl.plan_to_qpos(jc, js, np.asarray(q0), np.asarray(q1), env_points=env,
                              seed=seed)
        pt = tpl.plan_to_qpos(tc, ts, np.asarray(q0), np.asarray(q1), env_points=env,
                              seed=seed)
        _assert_same_plan(pt, pj)
    # the workspace box's floor touches the base's spheres: both refuse
    assert pt["status"] == ("Failure" if obstacle == "workspace" else "Success")
    path_j = jpl.RRTPlanner(jpl.CollisionModel(jc, js, env), seed=1).plan(q0, q1)
    path_t = tpl.RRTPlanner(tpl.CollisionModel(tc, ts, env), seed=1).plan(q0, q1)
    assert (path_t is None) == (path_j is None)
    if path_j is not None:
        assert len(path_t) == len(path_j)
        for a, b in zip(path_t, path_j):
            np.testing.assert_array_equal(a, b)


def test_rrt_detours_identically(rig):
    """A wall on the straight line forces the RRT and the shortcut rounds."""
    jc, tc, js, ts = rig
    env = _wall(tc, [0.0, 0.0])
    mj, mt = jpl.CollisionModel(jc, js, env), tpl.CollisionModel(tc, ts, env)
    q0, q1 = np.array([-0.5, 0.5]), np.array([0.5, 0.5])
    assert not mt.segment_free(q0, q1)
    for seed in (0, 1, 3):
        pj = jpl.RRTPlanner(mj, seed=seed).plan(q0, q1)
        pt = tpl.RRTPlanner(mt, seed=seed).plan(q0, q1)
        assert pj is not None and len(pj) > 2
        assert len(pt) == len(pj)
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)
    qs = np.random.default_rng(5).uniform(-1.5, 1.5, (40, 2))
    assert [mt.in_collision(q) for q in qs] == [mj.in_collision(q) for q in qs]


def test_plan_first_feasible_bit_identical(rig):
    jc, tc, js, ts = rig
    q0 = np.zeros(2, np.float32)
    blocked = np.asarray([1.2, 0.0], np.float32)
    free = np.asarray([-0.5, -0.3], np.float32)
    wall = _wall(tc, blocked, n=80, reach=0.0)
    for cands in ([blocked, free], [blocked]):
        cj, pj = jpl.plan_first_feasible(jc, js, q0, cands, env_points=wall, seed=0)
        ct, pt = tpl.plan_first_feasible(tc, ts, q0, cands, env_points=wall, seed=0)
        assert (ct is None) == (cj is None) and (pt is None) == (pj is None)
        if cj is not None:
            np.testing.assert_array_equal(ct, cj)
            _assert_same_plan(pt, pj)
    assert cj is None  # all candidates blocked: no move


@pytest.mark.parametrize("v_max,a_max,dt", [(0.5, 1.0, 0.01), (0.3, 1.0, 0.05)])
def test_time_parameterize_bit_identical(v_max, a_max, dt):
    paths = [[np.zeros(2), np.array([1.0, 0.0])],
             [np.zeros(2), np.array([0.3, -0.2]), np.array([0.31, 0.5])],
             [np.ones(2), np.ones(2)]]
    for path in paths:
        _assert_same_plan(tpl.time_parameterize(path, v_max, a_max, dt),
                          jpl.time_parameterize(path, v_max, a_max, dt))


def test_native_planner_matches_python(rig):
    _, tc, _, ts = rig
    if not tnp.native_available():
        pytest.skip("libezplan.so not built")
    planner = tnp.NativePlanner(tc, ts)
    q = np.asarray([0.4, -0.6])
    np.testing.assert_allclose(planner.fk(q), tc.fk_np(q), atol=1e-5)
    model = tpl.CollisionModel(tc, ts)
    qs = np.random.default_rng(0).uniform(tc.joint_limits[:, 0], tc.joint_limits[:, 1],
                                          (50, 2))
    assert [planner.in_collision(q) for q in qs] == [model.in_collision(q) for q in qs]
    plan = tnp.plan_to_qpos_native(tc, ts, np.zeros(2), np.asarray([0.5, 0.3]))
    assert plan["status"] == "Success"
    np.testing.assert_allclose(plan["position"][-1], [0.5, 0.3], atol=1e-2)
    grid = np.mgrid[-1:1:21j, -1:1:21j, 0:1:11j].reshape(3, -1).T
    assert tnp.NativePlanner(tc, ts, env_points=grid).in_collision(np.zeros(2))
