"""Port parity: easyhec_torch.geometry against easyhec_tpu.geometry on CPU.

Same numpy inputs through both packages. Tolerances are float32 roundoff:
the two packages evaluate the same closed forms with different libm / XLA
kernels (sin, cos, arccos, sqrt), so results agree to a few ulps of O(1)
quantities — atol 1e-6 for exp/project, 2e-6 for log (arccos/arcsin
amplify one ulp of the trace near θ = π).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.geometry import camera as tcam
from easyhec_torch.geometry import se3 as tse3
from easyhec_torch.geometry import so3 as tso3
from easyhec_tpu.geometry import camera as jcam
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.geometry import so3 as jso3
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _twists():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    # θ → 0 (inside and at the edge of the θ < 0.2 series branch), generic,
    # and θ → π
    thetas = np.array([0.0, 1e-7, 1e-3, 0.05, 0.19, 0.21, 0.7, 1.5, 2.5,
                       np.pi - 1e-2, np.pi - 1e-4, np.pi - 1e-6])
    w = axes * thetas[:, None]
    v = rng.uniform(-1, 1, (12, 3))
    return np.concatenate([v, w], axis=1).astype(np.float32)


XI = _twists()


def _both(fn_j, fn_t, x):
    return np.asarray(fn_j(jnp.asarray(x))), fn_t(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", ["exp", "hat"])
def test_so3_forward_maps(name):
    a, b = _both(getattr(jso3, name), getattr(tso3, name), XI[:, 3:])
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_so3_log_and_vee():
    R = np.asarray(jso3.exp(jnp.asarray(XI[:, 3:])))
    a, b = _both(jso3.log, tso3.log, R)
    np.testing.assert_allclose(a, b, atol=2e-6)
    a, b = _both(jso3.vee, tso3.vee, np.asarray(jso3.hat(jnp.asarray(XI[:, 3:]))))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["rotx", "roty", "rotz"])
def test_axis_rotations(fn):
    ang = np.linspace(-3, 3, 7).astype(np.float32)
    a, b = _both(getattr(jso3, fn), getattr(tso3, fn), ang)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_se3_exp_log_round_trip():
    Tj, Tt = _both(jse3.exp, tse3.exp, XI)
    np.testing.assert_allclose(Tj, Tt, atol=1e-6)
    lj, lt = _both(jse3.log, tse3.log, Tj)
    np.testing.assert_allclose(lj, lt, atol=2e-6)
    # round trip in the port itself: exp(log(T)) == T
    back = tse3.exp(tse3.log(torch.from_numpy(Tt))).numpy()
    np.testing.assert_allclose(back, Tt, atol=2e-6)


def test_se3_small_angle_series_branch():
    # θ = 1e-3 is where the closed forms lost 0.03 in log-translation before
    # the θ < 0.2 series branch (PARITY.md); both packages must agree there.
    xi = np.array([[0.3, -0.2, 0.5, 1e-3, 0.0, 0.0]], np.float32)
    lj, lt = _both(lambda x: jse3.log(jse3.exp(x)), lambda x: tse3.log(tse3.exp(x)), xi)
    np.testing.assert_allclose(lt, xi, atol=1e-6)
    np.testing.assert_allclose(lj, lt, atol=1e-6)


def test_se3_inverse_and_from_rt():
    T = np.asarray(jse3.exp(jnp.asarray(XI)))
    a, b = _both(jse3.inverse, tse3.inverse, T)
    np.testing.assert_allclose(a, b, atol=1e-6)
    R, t = T[:, :3, :3], T[:, :3, 3]
    np.testing.assert_array_equal(
        np.asarray(jse3.from_rt(jnp.asarray(R), jnp.asarray(t))),
        tse3.from_rt(torch.from_numpy(R), torch.from_numpy(t)).numpy(),
    )


def test_camera_look_at_and_projection():
    assert (tcam.NEAR_DEFAULT, tcam.FAR_DEFAULT) == (jcam.NEAR_DEFAULT, jcam.FAR_DEFAULT)
    eye = np.array([1.0, 0.7, 0.8], np.float32)
    tgt = np.array([0.0, 0.0, 0.3], np.float32)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    Tj = np.asarray(jcam.look_at(*(jnp.asarray(a) for a in (eye, tgt, up))))
    Tt = tcam.look_at(*(torch.from_numpy(a) for a in (eye, tgt, up))).numpy()
    np.testing.assert_allclose(Tj, Tt, atol=1e-6)
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
    pts = np.random.default_rng(1).uniform(-1, 1, (50, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.1
    pts[0, 2] = 0.0  # the |z| < eps clamp
    (uj, zj) = jcam.project_points(jnp.asarray(K), jnp.asarray(pts))
    (ut, zt) = tcam.project_points(torch.from_numpy(K), torch.from_numpy(pts))
    np.testing.assert_allclose(np.asarray(uj), ut.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(zj), zt.numpy())


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    return np.asarray(jso3.exp(jnp.asarray(w)))


def test_transform_points_and_matrix_3x4_to_4x4():
    rng = np.random.default_rng(4)
    T = np.asarray(jse3.exp(jnp.asarray(XI[:5])))[:, None]  # [5, 1, 4, 4]
    pts = rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    pj = np.asarray(jse3.transform_points(jnp.asarray(T[:, 0]), jnp.asarray(pts)))
    pt = tse3.transform_points(torch.from_numpy(T[:, 0]), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-6)
    M = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
    mj, mt = _both(jse3.matrix_3x4_to_4x4, tse3.matrix_3x4_to_4x4, M)
    np.testing.assert_array_equal(mt, mj)
    assert mt.shape == (2, 3, 4, 4)


def test_geodesic_distance():
    """Elementwise trace, as JAX has it, on generic pairs and on pairs a
    known angle apart (0.19 to 2.5 rad). Tolerance as so3.log's; angles
    within ~1e-2 of 0 or π are left out: there arccos turns one ulp of the
    trace into ~3e-4 rad."""
    R1, R2 = _rotations(16, 1), _rotations(16, 2)
    w = XI[4:9, 3:]
    apart = R1[:5] @ np.asarray(jso3.exp(jnp.asarray(w)))
    for a, b in ((R1, R2), (R1[:5], apart)):
        dj = np.asarray(jso3.geodesic_distance(jnp.asarray(a), jnp.asarray(b)))
        dt = tso3.geodesic_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=2e-6)
    np.testing.assert_allclose(dt, np.linalg.norm(w, axis=1), atol=1e-5)


@pytest.mark.parametrize("cull", [False, True])
def test_soa_transform_and_setup(cull):
    """transform_verts_soa and setup_triangles_soa on a seeded multi-mesh
    scene: the culls bit-equal, values rtol 1e-6 (atol 1e-6 for the camera
    coordinates, which cross 0)."""
    from easyhec_torch.render import projection as tp
    from easyhec_tpu.render import projection as jp

    rng = np.random.default_rng(11)
    V, F, M = 60, 80, 3
    verts = [rng.uniform(-0.3, 0.3, V).astype(np.float32) for _ in range(3)]
    mesh_id = rng.integers(0, M, V).astype(np.int32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    xi = np.concatenate([rng.uniform(-0.2, 0.2, (2, M, 3)),
                         rng.uniform(-0.5, 0.5, (2, M, 3))], -1).astype(np.float32)
    poses = np.array(jse3.exp(jnp.asarray(xi)))  # [2, M, 4, 4]
    poses[..., 2, 3] += 1.0  # in front of the camera, a few behind near
    poses[1, 0, 2, 3] = -0.2
    K = np.array([[90.0, 0, 40.0], [0, 90.0, 30.0], [0, 0, 1]], np.float32)
    xyz_j = jp.transform_verts_soa(tuple(map(jnp.asarray, verts)), jnp.asarray(mesh_id),
                                   jnp.asarray(poses))
    xyz_t = tp.transform_verts_soa(tuple(map(torch.from_numpy, verts)),
                                   torch.from_numpy(mesh_id), torch.from_numpy(poses))
    for a, b in zip(xyz_j, xyz_t):
        assert b.shape == (2, V)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    tj = jp.setup_triangles_soa(tuple(xyz_j), jnp.asarray(faces), jnp.asarray(K),
                                cull_backfaces=cull)
    tt = tp.setup_triangles_soa(tuple(torch.from_numpy(np.asarray(a)) for a in xyz_j),
                                torch.from_numpy(faces), torch.from_numpy(K),
                                cull_backfaces=cull)
    assert tt.n_faces == tj.n_faces == F
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(tj.valid))
    assert 0 < tt.valid.sum() < 2 * F
    for f in ("u", "v", "z"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), np.asarray(getattr(tj, f)),
                                   rtol=1e-6)
