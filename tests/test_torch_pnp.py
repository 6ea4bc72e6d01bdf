"""Port parity: easyhec_torch.models.pose_init.ransac_pnp against
easyhec_tpu's on the CPU, on noisy correspondences (0.5 px) with 30 %
outliers, both packages seeing the same RANSAC samples: the port's
``draw_ransac_samples`` is replaced by JAX's draws (pose_init.py:295-298).

The reference takes each DLT solution P as the SVD returns it. When the
SVD returns -P, JAX orthonormalizes -M and gets a rotation that is not
the camera's. The port takes P with det(M) > 0 (see ransac_pnp). The
parity test feeds JAX an SVD whose DLT null vector has that same sign, and
then holds R and t at atol 1e-4 and the inlier mask equal. The second test
runs the reference as it is on those inputs, where the divergence shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.models import pose_init as tp
from easyhec_tpu.data.synthetic import default_camera
from easyhec_tpu.models.pose_init import ransac_pnp as j_ransac_pnp
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SEEDS = range(6)
K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)


def jax_samples(seed, N, n_iters, generator=None):
    """JAX's RANSAC draws, as easyhec_tpu/models/pose_init.py:295-298."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    idx = jax.vmap(lambda k: jax.random.choice(k, N, (6,), replace=False))(keys)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def correspondences(seed, N=120):
    """Points in a box around the arm's workspace, their projections with
    0.5 px noise, 30 % of them replaced by uniform outliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-0.3, -0.3, 0.0], [0.3, 0.3, 0.6], (N, 3)).astype(np.float32)
    Tc = default_camera(distance=1.2, azimuth_deg=30 + 20 * seed, height=0.7,
                        target=(0, 0, 0.3)).astype(np.float32)
    pc = X @ Tc[:3, :3].T + Tc[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 600.0 + np.array([320.0, 240.0])
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random(N) < 0.3
    uv[out] = rng.uniform([0, 0], [640, 480], (int(out.sum()), 2))
    return X, uv.astype(np.float32), Tc, ~out


def _signed_dlt_svd(svd):
    def wrapped(a, *args, **kw):
        res = svd(a, *args, **kw)
        if a.shape[-1] != 12:
            return res
        u, s, vt = res  # the 2k×12 DLT system: its null vector with det(M) > 0
        P = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 4))
        sgn = jnp.where(jnp.linalg.det(P[..., :3]) < 0, -1.0, 1.0)
        return type(res)(u, s, vt.at[..., -1, :].multiply(sgn[..., None]))

    return wrapped


@pytest.mark.parametrize("seed", SEEDS)
def test_ransac_pnp_matches_jax(seed, monkeypatch):
    monkeypatch.setattr(tp, "draw_ransac_samples", jax_samples)
    monkeypatch.setattr(jnp.linalg, "svd", _signed_dlt_svd(jnp.linalg.svd))
    X, uv, Tc, true_inl = correspondences(seed)
    Tj, inl_j = j_ransac_pnp(X, uv, K, seed=seed)
    Tt, inl_t = tp.ransac_pnp(X, uv, K, seed=seed, device="cpu")
    np.testing.assert_array_equal(inl_t, inl_j)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    assert np.abs(Tt - Tc).max() < 1e-2 and (inl_t & ~true_inl).sum() <= 1


def test_ransac_pnp_sign_divergence_from_jax(monkeypatch):
    """The reference as it is: on these inputs its DLT solve comes back with
    det(M) < 0 for some seeds, and its pose is then off by a rotation; the
    port's is within 1 cm of the truth at every seed."""
    monkeypatch.setattr(tp, "draw_ransac_samples", jax_samples)
    jax_off = 0
    for seed in SEEDS:
        X, uv, Tc, _ = correspondences(seed)
        Tj, _ = j_ransac_pnp(X, uv, K, seed=seed)
        Tt, _ = tp.ransac_pnp(X, uv, K, seed=seed, device="cpu")
        assert np.abs(Tt - Tc).max() < 1e-2
        jax_off += np.abs(Tj - Tc).max() > 0.1
    assert jax_off > 0


def test_ransac_samples_and_guard():
    a = tp.draw_ransac_samples(3, 10, 50)
    assert a.shape == (50, 6) and a.dtype == torch.int64
    assert all(len(set(r.tolist())) == 6 for r in a) and int(a.max()) < 10
    np.testing.assert_array_equal(tp.draw_ransac_samples(3, 10, 50).numpy(), a.numpy())
    with pytest.raises(ValueError, match=">= 6"):
        tp.ransac_pnp(np.zeros((5, 3)), np.zeros((5, 2)), K, device="cpu")
