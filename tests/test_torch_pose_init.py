"""Port parity: easyhec_torch.models.pose_init.global_search_init against
easyhec_tpu's, on CPU, at a tiny size: the mini arm at 48×64 with downscale
2 (24×32 scoring renders), 8 view directions × 2 radii × 2 rolls (32
candidates), top 2, 5 refine steps, one frame. JAX's scoring renderer runs
K5 in interpret mode, the port's the plain versions.

The candidate scores are held to atol 1e-5 (the same soft IoU summed in
another order). The top-k order must be equal; the test asserts first that
the sorted scores around the top k are separated by more than that
tolerance, so the order is not decided by rounding. The refined pose and
its IoU go through 5 Adam steps, each normalizing its gradient, so they are
held to 1e-4 (pose entries) and 1e-4 (IoU).
"""
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.models import pose_init as tpi
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_tpu.models import pose_init as jpi
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]
CFG = dict(tile_h=16, tile_w=32, capacity=256, binner="count", fused=True, margin=2.0)
SEARCH = dict(radii=(0.9, 1.3), n_dirs=8, n_roll=2, downscale=2, topk=2, refine_steps=5)


@pytest.fixture(scope="module")
def scene():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    model = parse_urdf(path)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    mesh_list = [meshes[n] for n in LINKS]
    jr = JR(mesh_list, H, W, tile=JTC(**CFG))
    tr = TR(mesh_list, H, W, tile=TTC(**CFG), device="cpu")
    lp = np.asarray(chain.fk(jnp.asarray([0.3, -0.4]))[jnp.asarray([0, 1, 2])])[None]
    Tgt = jpi.lookat_init([0.9, 0.5, 0.6], [0, 0, 0.2]).astype(np.float32)  # camera-from-base
    mask = np.asarray(jr.silhouette(jnp.asarray(Tgt), jnp.asarray(lp), jnp.asarray(K)))
    return jr, tr, lp, (mask > 0.5).astype(np.float32), Tgt, mesh_list


def test_search_helpers_match():
    np.testing.assert_array_equal(tpi._fibonacci_hemisphere(16), jpi._fibonacci_hemisphere(16))
    m = np.random.default_rng(0).random((2, 6, 10)).astype(np.float32)
    for a, b in zip(tpi._mask_moments(torch.from_numpy(m)), jpi._mask_moments(jnp.asarray(m))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _hold_to_jax(tres, jres):
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-5)
    np.testing.assert_allclose(tres.scores, jres.scores, atol=1e-5)
    k = SEARCH["topk"]
    srt = np.sort(jres.scores)[::-1]
    assert np.all(np.diff(srt[: k + 1]) < -1e-4), srt[: k + 1]  # no near-ties
    np.testing.assert_array_equal(np.argsort(-tres.scores, kind="stable")[:k],
                                  np.argsort(-jres.scores, kind="stable")[:k])
    assert 0 < tres.score <= 1
    np.testing.assert_allclose(tres.score, jres.score, atol=1e-4)
    np.testing.assert_allclose(tres.Tc_c2b, jres.Tc_c2b, atol=1e-4)


def test_global_search_init_matches(scene):
    jr, tr, lp, mask, Tgt, _ = scene
    jres = jpi.global_search_init(jr, lp, K, mask, **SEARCH)
    tres = tpi.global_search_init(tr, lp, K, mask, **SEARCH)
    _hold_to_jax(tres, jres)
    assert tres.tiles_at_cap == 0


def test_global_search_truncation_matches(scene):
    """The scoring tiles at capacity: cap 64 fills 0.59 of the 24×32
    renders' bins (0 at the fixture's 256), so both packages drop the same
    slots; the scores, top-k order and refined pose still match."""
    _, _, lp, mask, _, mesh_list = scene
    cfg = dict(CFG, capacity=64)
    jres = jpi.global_search_init(JR(mesh_list, H, W, tile=JTC(**cfg)), lp, K, mask, **SEARCH)
    tres = tpi.global_search_init(TR(mesh_list, H, W, tile=TTC(**cfg), device="cpu"), lp, K,
                                  mask, **SEARCH)
    assert tres.tiles_at_cap > 0.5
    _hold_to_jax(tres, jres)
