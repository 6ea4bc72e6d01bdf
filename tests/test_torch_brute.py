"""Port parity: the two render options that run without a kernel,
``RobotRenderer(mode="brute")`` (render/raster_jnp.py, raster_core's
coverage_from_edges) and ``TileConfig(use_pallas=False)`` (the plain-tensor
tiled rasterizer, tiled._silhouette_tiled_single), against easyhec_tpu's on
the CPU, on the mini arm (MINI_URDF) at 48×64.

Tolerances: silhouettes atol 1e-5 (the same f32 terms summed in another
order), the rasterizers fed the same screen triangles (bit-exact on this
CPU: torch's f32 matmul rounds as XLA's CPU dot); the brute renderer end to
end atol 1e-4, because its AoS triangle setup (held to JAX's at atol 1e-4
in test_torch_tiled.py) puts vertices up to 2 ulp
(7.6e-6 px) from JAX's on this scene, which moves a coverage value by up
to 1.9e-5; brute depth z rtol 1e-5 with the triangle ids equal except at
equal-depth ties (at most 1 % of the hit pixels); the plain-tensor route's
pose gradient rel 1e-4 of max|g|; 30-step adaptive ``calibrate`` runs at
test_torch_calib.py's trace tolerance (losses rtol 1e-3, pose atol 1e-4).
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.geometry import se3 as tse3
from easyhec_torch.models import calib as tc
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.render.projection import Triangles2D
from easyhec_torch.render.raster_jnp import depth_bruteforce as t_depth
from easyhec_torch.render.raster_jnp import silhouette_bruteforce as t_sil_brute
from easyhec_torch.render.tiled import silhouette_tiled as t_sil_tiled
from easyhec_tpu.data.synthetic import default_camera
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.models import calib as jc
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.render.raster_jnp import depth_bruteforce as j_depth
from easyhec_tpu.render.raster_jnp import silhouette_bruteforce as j_sil_brute
from easyhec_tpu.render.tiled import silhouette_tiled as j_sil_tiled
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from easyhec_tpu.robot.mesh import subdivide_to_max_edge
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]
# test_torch_calib.py's route: the fused gates must fall through to the
# stateless routes under either option
CFG = dict(tile_h=16, tile_w=32, capacity=256, binner="count", fused=True,
           margin=2.0, bin_big_k=128, compact_chunks=16, bwd_band_only=True)
OFFSET = np.array([0.02, -0.02, 0.015, 0.01, -0.01, 0.015], np.float32)


@pytest.fixture(scope="module")
def scene():
    """The mini arm, subdivided to 4 cm edges (1184 triangles, up to 435 in
    a 16×32 tile) under a close camera, two frames."""
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    model = parse_urdf(path)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    coarse = [meshes[n] for n in LINKS]
    fine = [subdivide_to_max_edge(m, 0.04) for m in coarse]
    qs = jnp.linspace(-0.3, 0.3, 2 * chain.n_dof).reshape(2, chain.n_dof)
    lp = np.asarray(jax.vmap(chain.fk)(qs)[:, jnp.asarray([0, 1, 2])])
    Tc = default_camera(distance=0.7, azimuth_deg=30, height=0.5,
                        target=(0, 0, 0.25)).astype(np.float32)
    return coarse, fine, lp, Tc


def _pair(meshes, mode="tiled", **tile):
    return (JR(meshes, H, W, tile=JTC(**tile), mode=mode),
            TR(meshes, H, W, tile=TTC(**tile), mode=mode, device="cpu"))


def _args_j(Tc, lp):
    return jnp.asarray(Tc), jnp.asarray(lp), jnp.asarray(K)


def _args_t(Tc, lp):
    return torch.from_numpy(np.array(Tc)), torch.from_numpy(np.array(lp)), torch.from_numpy(K)


def _same_triangles(jr, Tc, lp):
    """JAX's AoS screen triangles, and the same arrays as torch tensors."""
    Tj, lpj, Kj = _args_j(Tc, lp)
    tj = jr._triangles(jr.camera_link_poses(Tj, lpj), Kj)
    return tj, Triangles2D(*(torch.from_numpy(np.array(a)) for a in tj))


def test_brute_silhouette_matches_jax(scene):
    _, fine, lp, Tc = scene
    jr, tr = _pair(fine, mode="brute", **CFG)
    tj, tt = _same_triangles(jr, Tc, lp)
    sj = np.asarray(j_sil_brute(tj, H, W))
    assert sj.shape == (2, H, W) and sj.mean() > 0.05
    np.testing.assert_allclose(t_sil_brute(tt, H, W).numpy(), sj, atol=1e-5)
    st = tr.silhouette(*_args_t(Tc, lp)).numpy()
    np.testing.assert_allclose(st, np.asarray(jr.silhouette(*_args_j(Tc, lp))), atol=1e-4)
    # the fused gate falls through to the counting binner's stateless state
    assert type(tr.bin_state(*_args_t(Tc, lp))).__name__ == "BinState"


def test_brute_depth_matches_jax(scene):
    _, fine, lp, Tc = scene
    jr, tr = _pair(fine, mode="brute", **CFG)
    tj, tt = _same_triangles(jr, Tc, lp)
    zj, idj = (np.asarray(a) for a in j_depth(tj, H, W))
    zt, idt = (a.numpy() for a in t_depth(tt, H, W))
    hit = idj >= 0
    np.testing.assert_array_equal(idt >= 0, hit)
    assert hit.mean() > 0.05
    np.testing.assert_allclose(zt[hit], zj[hit], rtol=1e-5)
    assert (idt[hit] != idj[hit]).mean() <= 0.01
    # the renderer's depth: link ids through the same ids
    _, lid_j = jr.depth(*_args_j(Tc, lp))
    _, lid_t = tr.depth(*_args_t(Tc, lp))
    assert (lid_t.numpy() != np.asarray(lid_j)).mean() <= 0.01


@pytest.mark.parametrize("cap", [256, 448])  # one dense pass; 128-record chunks
def test_plain_tiled_silhouette_matches_jax(scene, cap):
    _, fine, lp, Tc = scene
    tile = dict(CFG, capacity=cap, use_pallas=False)
    jr, tr = _pair(fine, **tile)
    sj = np.asarray(jr.silhouette(*_args_j(Tc, lp)))
    st = tr.silhouette(*_args_t(Tc, lp)).numpy()
    assert sj.mean() > 0.05
    np.testing.assert_allclose(st, sj, atol=1e-5)
    # the rasterizer on the same triangles, and its overflow flag (cap 256
    # truncates the fullest tiles, as in JAX)
    tj, tt = _same_triangles(jr, Tc, lp)
    sj, ovj = j_sil_tiled(tj, H, W, jr.tile, return_overflow=True)
    st, ovt = t_sil_tiled(tt, H, W, tr.tile, return_overflow=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    assert bool(ovt) == bool(ovj) == (cap == 256)


@pytest.mark.parametrize("cap", [256, 448])
def test_plain_tiled_pose_gradient_matches_jax(scene, cap):
    _, fine, lp, Tc = scene
    jr, tr = _pair(fine, **dict(CFG, capacity=cap, use_pallas=False))
    xi = np.asarray(jse3.log(jnp.asarray(Tc))) + OFFSET
    target = (np.asarray(jr.silhouette(*_args_j(Tc, lp))) > 0.5).astype(np.float32)

    def jloss(d):
        sil = jr.silhouette(jse3.exp(d), jnp.asarray(lp), jnp.asarray(K))
        return jnp.sum((sil - target) ** 2)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(xi)))
    d = torch.from_numpy(xi).requires_grad_()
    sil = tr.silhouette(tse3.exp(d), torch.from_numpy(lp), torch.from_numpy(K))
    torch.sum((sil - torch.from_numpy(target)) ** 2).backward()
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(d.grad.numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max())


@pytest.fixture(scope="module")
def calib_rig(scene):
    """test_torch_calib.py's rig: the coarse mini arm at Tc z = 1.2 m, the
    target masks from the JAX brute render at GT."""
    coarse, _, lp, _ = scene
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    gt = np.asarray(jse3.log(jnp.asarray(Tc)))
    jr = JR(coarse, H, W, tile=JTC(**CFG), mode="brute")
    target = (np.asarray(jr.silhouette(*_args_j(Tc, lp))) > 0.5).astype(np.float32)
    return coarse, lp, gt, target


@pytest.mark.parametrize("option", [{"mode": "brute"}, {"use_pallas": False}],
                         ids=["brute", "plain_tiled"])
def test_calibrate_30_steps_on_option_matches_jax(calib_rig, option):
    coarse, lp, gt, target = calib_rig
    mode = option.get("mode", "tiled")
    tile = dict(CFG, use_pallas=option.get("use_pallas", True))
    jr, tr = _pair(coarse, mode=mode, **tile)
    assert not tc.reuse_bins_ok(tr) and not jc.reuse_bins_ok(jr)
    assert tc.tile_masks(target, tr) is None
    init = gt + OFFSET
    jres = jc.calibrate(init, jr, lp, K, target, num_steps=30, rebin_every=0)
    tres = tc.calibrate(init, tr, lp, K, target, num_steps=30, rebin_every=0)
    assert tres.rebins == jres.rebins and not tres.overflow
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tres.history, jres.history, atol=1e-4)
    np.testing.assert_allclose(tres.dof, jres.dof, atol=1e-4)
    assert tres.losses[-1] < tres.losses[0]


def test_unknown_render_mode_raises(scene):
    with pytest.raises(ValueError, match="render mode"):
        TR(scene[0], H, W, mode="wire", device="cpu")
