"""End result: the port's analytic pose gradient against central differences
of its own forward, on the CPU (the kernels' plain PyTorch versions).

Counterpart of tests/test_fused.py:172
(``TestFusedGradient.test_grad_vs_finite_differences``, marked slow there),
on its rig: a box and a cylinder at 64×64, ``TileConfig(16, 32, 128,
binner="count", fused=True)`` without culling, the three frames of
test_fused.py's ``_poses`` (link offsets drawn by
``jax.random.PRNGKey(0)``), the target the unfused route's silhouette at
Tc = exp([0.02, -0.03, 1.2, 0.05, -0.08, 0.03]), the gradient taken at
log(Tc) + [0.004, -0.003, 0.002, 0.003, -0.002, 0.004]; the loss the mean
over frames of Σ(image − target)². Its tolerance: each component within
max(12 % of the FD component, 3 % of max|g|) of the central difference at
eps 1e-4.

The JAX test holds its fused silhouette (K4). Here each route's own loss:
the compact fused loss (``loss_fused`` on a CompactState: K2f/K2b), the
dense one (a FusedState: K1f/K1b), the dense route's silhouette (K4f/K4b,
the JAX test's function) and the unfused silhouette (K5f and the counted
K5b, then autograd through the triangle setup).
"""
import jax
import numpy as np
import pytest
import torch

from easyhec_torch.geometry import se3
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.render.fused import CompactState, FusedState, loss_fused
from easyhec_torch.robot import make_box, make_cylinder
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H = W = 64
CFG = dict(tile_h=16, tile_w=32, capacity=128, binner="count", fused=True)
XI = [0.02, -0.03, 1.2, 0.05, -0.08, 0.03]
OFFSET = [0.004, -0.003, 0.002, 0.003, -0.002, 0.004]
EPS = 1e-4
ROUTES = {  # name: (tile config, loss through loss_fused (else the silhouette), state type)
    "compact": (dict(CFG, compact_chunks=12), True, CompactState),
    "dense": (CFG, True, FusedState),
    "dense_silhouette": (CFG, False, None),
    "unfused": (dict(CFG, fused=False), False, None),
}


def _renderer(cfg):
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    return RobotRenderer(meshes, H, W, tile=TileConfig(**cfg), device="cpu")


def _link_poses(B=3):
    """tests/test_fused.py::_poses' link poses: frame 0 the two links at the
    base and 0.3 m up, each later frame the second link moved by a
    jax.random.uniform(-0.2, 0.2) draw from PRNGKey(0) split once a frame."""
    lp = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    key = jax.random.PRNGKey(0)
    for i in range(1, B):
        key, k = jax.random.split(key)
        lp[i, 1, :3, 3] += np.asarray(jax.random.uniform(k, (3,), minval=-0.2, maxval=0.2))
    return torch.from_numpy(lp)


@pytest.fixture(scope="module")
def rig():
    lp = _link_poses()
    K = torch.tensor([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]])
    Tc = se3.exp(torch.tensor(XI))
    with torch.no_grad():
        target = _renderer(ROUTES["unfused"][0]).silhouette(se3.exp(se3.log(Tc)), lp, K)
    return lp, K, Tc, target


@pytest.mark.parametrize("route", list(ROUTES))
def test_grad_vs_finite_differences(rig, route):
    lp, K, Tc, target = rig
    cfg, fused_loss, state_type = ROUTES[route]
    r = _renderer(cfg)
    if state_type is not None:  # the route the tile config selects
        st = r.bin_state(Tc, lp, K)
        assert isinstance(st, state_type) and not bool(st.overflow.any())

    def loss(x):
        if fused_loss:
            return loss_fused(r, se3.exp(x), lp, K, target).mean()
        return ((r.silhouette(se3.exp(x), lp, K) - target) ** 2).sum((-2, -1)).mean()

    xi0 = se3.log(Tc) + torch.tensor(OFFSET)
    x = xi0.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(x), x)
    g = g.numpy()
    gmax = np.abs(g).max()
    assert gmax > 0
    with torch.no_grad():
        for i in range(6):
            e = torch.zeros(6)
            e[i] = EPS
            fd = (float(loss(xi0 + e)) - float(loss(xi0 - e))) / (2 * EPS)
            tol = max(0.12 * abs(fd), 0.03 * gmax)
            assert abs(g[i] - fd) < tol, (route, i, g[i], fd)
