"""Port parity: easyhec_torch.models.pose_init.global_search_init against
easyhec_tpu's, on CPU, at a tiny size: the mini arm at 48×64 with downscale
2 (24×32 scoring renders), 8 view directions × 2 radii × 2 rolls (32
candidates, one sweep batch), top 2, 5 refine steps, one frame; and 13 × 2
× 3 (78 candidates: a batch of 64 and a ragged one of 14, padded with
copies of candidate 0). JAX's scoring renderer runs K5 in interpret mode,
the port's the plain versions.

The candidate scores are held to atol 1e-5 (the same soft IoU summed in
another order). The top-k order must be equal; the test asserts first that
the sorted scores around the top k are separated by more than that
tolerance, so the order is not decided by rounding. The refined pose and
its IoU go through 5 Adam steps, each normalizing its gradient, so they are
held to 1e-4 (pose entries) and 1e-4 (IoU).
"""
import tempfile

import jax
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
RAGGED = dict(SEARCH, n_dirs=13, n_roll=3)  # 78 candidates: 64 + 14


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


def _jax_candidate_poses(target, radii, n_dirs, n_roll):
    """The JAX package's candidates (easyhec_tpu/models/pose_init.py:127-143,
    a closure there): its look_at and se3.inverse per eye, the roll
    left-multiplied, vmapped eye-major."""
    from easyhec_tpu.geometry import camera as jcam
    from easyhec_tpu.geometry import se3 as jse3

    dirs = jpi._fibonacci_hemisphere(n_dirs)
    eyes = np.concatenate([target + float(r) * dirs for r in radii])
    rolls = np.linspace(0.0, 2 * np.pi, n_roll, endpoint=False, dtype=np.float32)

    def pose_for(eye, roll):
        T = jse3.inverse(jcam.look_at(eye, jnp.asarray(target), jnp.asarray([0.0, 0.0, 1.0])))
        c, s = jnp.cos(roll), jnp.sin(roll)
        Rz = jnp.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        return T.at[:3, :3].set(Rz @ T[:3, :3]).at[:3, 3].set(Rz @ T[:3, 3])

    poses = jax.vmap(lambda e: jax.vmap(lambda r: pose_for(e, r))(jnp.asarray(rolls)))(
        jnp.asarray(eyes))
    return np.asarray(poses).reshape(-1, 4, 4)


@pytest.mark.parametrize("n_dirs,radii,n_roll", [(13, (0.9, 1.3), 3),
                                                  (128, (0.6, 1.0, 1.5), 8)],
                         ids=["ragged78", "default3072"])
def test_candidate_poses_match_jax(n_dirs, radii, n_roll):
    """The batched candidates (every eye's look_at, the rolls broadcast over
    them) against the JAX package's vmapped ones, in its eye-major order."""
    target = np.array([0.05, -0.02, 0.3], np.float32)
    got = tpi._candidate_poses(target, radii, n_dirs, n_roll).numpy()
    want = _jax_candidate_poses(target, radii, n_dirs, n_roll)
    assert got.shape == want.shape == (len(radii) * n_dirs * n_roll, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


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


def _tiles_at_cap(tr, lp, mask, poses, downscale):
    """Share of the scoring renders' tiles at capacity over the candidates
    ``poses`` alone, binned in one batch (no padding)."""
    from easyhec_torch.models.calib import downscale_K

    Hs, Ws = mask.shape[-2] // downscale, mask.shape[-1] // downscale
    sr = tpi._scoring_renderer(tr, Hs, Ws)
    T = torch.from_numpy(poses)[:, None]
    lpt = torch.tensor(lp).expand((len(poses),) + lp.shape)
    st = sr.bin_state(T, lpt, torch.from_numpy(downscale_K(K, downscale)))
    return int((st.counts >= sr.tile.capacity).sum()) / st.counts.numel()


def _refine_grads_match(jr, tr, lp, mask, tres, downscale):
    """The gradient refinement's gradient, the port's against JAX's at the
    same poses (the port's top-k candidates and its refined pose): within
    1e-4 of each pose's max|g| (f32 sums of the same terms in another
    order)."""
    from easyhec_torch.geometry import se3 as tse3
    from easyhec_torch.models.calib import downscale_K
    from easyhec_tpu.geometry import se3 as jse3

    Hs, Ws = H // downscale, W // downscale
    Ks = downscale_K(K, downscale)
    lo = mask.reshape(1, Hs, downscale, Ws, downscale).mean((2, 4))
    top = np.argsort(-tres.scores, kind="stable")[: RAGGED["topk"]]
    dofs = tse3.log(torch.from_numpy(np.concatenate([tres.poses[top], tres.Tc_c2b[None]])))
    jsr = jpi._scoring_renderer(jr, Hs, Ws)

    def jloss(d):  # easyhec_tpu's refinement loss (a closure there)
        sil = jsr.silhouette(jse3.exp(d), jnp.asarray(lp), jnp.asarray(Ks))
        return ((sil - lo) ** 2).sum((-2, -1)).mean()

    gj = np.stack([np.asarray(jax.grad(jloss)(jnp.asarray(d))) for d in dofs.numpy()])
    sr = tpi._scoring_renderer(tr, Hs, Ws)
    d = dofs.clone().requires_grad_()
    sil = sr.silhouette(tse3.exp(d)[:, None], torch.tensor(lp).expand((len(d),) + lp.shape),
                        torch.from_numpy(Ks))
    (gt,) = torch.autograd.grad(((sil - torch.from_numpy(lo)) ** 2).sum((-2, -1)).mean(-1).sum(), d)
    np.testing.assert_array_less(np.abs(gt.numpy() - gj) / np.abs(gj).max(1, keepdims=True), 1e-4)


@pytest.mark.parametrize("capacity", [256, 64])
def test_global_search_ragged_batch_matches(scene, capacity, monkeypatch):
    """78 candidates, so the sweep's second batch holds 14 real candidates
    and 50 copies of candidate 0: the scores (1e-5) and top-k order match
    JAX's lax.map(batch_size=64), tiles_at_cap counts the 78 real
    candidates' tiles only (equal to one unpadded bin state of them all),
    and the refinement's gradient matches JAX's at the same poses. At cap
    256 the refined pose and IoU match too (1e-4). At cap 64 the bins
    truncate and the refined poses are not held: the gradients agree to
    ~3e-6 of max|g| at the same poses, but the two Adam trajectories at lr
    2e-2 part by 6e-8, 1e-7, 9e-7, 6e-6, 5e-3 and 2e-2 in the pose after 0
    to 5 steps."""
    _, _, lp, mask, _, mesh_list = scene
    cfg = dict(CFG, capacity=capacity)
    # JAX's scoring renderers are cached by id(renderer), which a renderer
    # freed by an earlier case can hand to this one
    monkeypatch.setattr(jpi, "_SCORING_CACHE", {})
    jr = JR(mesh_list, H, W, tile=JTC(**cfg))
    jres = jpi.global_search_init(jr, lp, K, mask, **RAGGED)
    tr = TR(mesh_list, H, W, tile=TTC(**cfg), device="cpu")
    tres = tpi.global_search_init(tr, lp, K, mask, **RAGGED)
    assert tres.scores.shape == (78,)
    if capacity == 256:
        _hold_to_jax(tres, jres)
    else:
        np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-5)
        np.testing.assert_allclose(tres.scores, jres.scores, atol=1e-5)
        k = RAGGED["topk"]
        srt = np.sort(jres.scores)[::-1]
        assert np.all(np.diff(srt[: k + 1]) < -1e-4), srt[: k + 1]
        np.testing.assert_array_equal(np.argsort(-tres.scores, kind="stable")[:k],
                                      np.argsort(-jres.scores, kind="stable")[:k])
    _refine_grads_match(jr, tr, lp, mask, tres, RAGGED["downscale"])
    want = _tiles_at_cap(tr, lp, mask, tres.poses, RAGGED["downscale"])
    assert tres.tiles_at_cap == want
    assert (want > 0.3) if capacity == 64 else (want == 0)
