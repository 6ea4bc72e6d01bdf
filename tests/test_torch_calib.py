"""Port parity: easyhec_torch.models.calib / solver.optim / convert against
easyhec_tpu on CPU, on the mini arm (MINI_URDF) at 48×64 with the compact
fused route and adaptive rebinning.

Tolerances: the mask loss and its pose gradient sum the same terms in
another order (value rtol 1e-5; gradient rtol 1e-4 with a floor of 1e-4 of
its largest component). Over a 30-step Adam trajectory those roundoff
differences are renormalized by Adam every step, so the loss trace is held
to rtol 1e-3 and the final pose to atol 1e-4 (measured: ~2e-6 and ~2e-7),
with the same number of drift-triggered rebins.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch import convert
from easyhec_torch.models import calib as tc
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.render.fused import silhouette_compact
from easyhec_torch.solver.optim import make_optimizer as t_make_optimizer
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.models import calib as jc
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from easyhec_tpu.solver.optim import make_optimizer as j_make_optimizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]
CFG = dict(tile_h=16, tile_w=32, capacity=256, binner="count", fused=True,
           margin=2.0, bin_big_k=128, compact_chunks=16, bwd_band_only=True)
OFFSET = np.array([0.02, -0.02, 0.015, 0.01, -0.01, 0.015], np.float32)


@pytest.fixture(scope="module")
def rig():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    model = parse_urdf(path)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    mesh_list = [meshes[n] for n in LINKS]
    jr = JR(mesh_list, H, W, tile=JTC(**CFG))
    tr = TR(mesh_list, H, W, tile=TTC(**CFG), device="cpu")
    convert.check_renderer_static(tr, jr)
    qs = jnp.linspace(-0.3, 0.3, 2 * chain.n_dof).reshape(2, chain.n_dof)
    lp = np.asarray(jax.vmap(chain.fk)(qs)[:, jnp.asarray([0, 1, 2])])
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    gt = np.asarray(jse3.log(jnp.asarray(Tc)))
    # target masks from the port's forward (held to JAX's in test_torch_fused)
    args = (torch.from_numpy(Tc), torch.from_numpy(lp), torch.from_numpy(K))
    st = tr.bin_state(*args)
    target = (silhouette_compact(tr, args[0], args[2], st) > 0.5).float().numpy()
    return jr, tr, lp, gt, target


def test_renderer_static_arrays_from_meshes(rig):
    jr, tr = rig[:2]
    arrs = convert.renderer_static_arrays(tr.meshes)
    np.testing.assert_array_equal(arrs["corners_rest"], np.asarray(jr.corners_rest))
    np.testing.assert_array_equal(arrs["face_link_onehot"], np.asarray(jr.face_link_onehot))
    np.testing.assert_array_equal(arrs["link_aabb_corners"], jr.link_aabb_corners())


def test_mask_loss_value_and_grad(rig):
    jr, tr, lp, gt, target = rig
    xi = gt + OFFSET
    js = jr.bin_state(jse3.exp(jnp.asarray(xi)), jnp.asarray(lp), jnp.asarray(K))
    vj, gj = jax.value_and_grad(lambda d: jc.mask_loss(
        d, jr, jnp.asarray(lp), jnp.asarray(K), jnp.asarray(target), bin_state=js,
        ref_tiles=jc.tile_masks(target, jr)))(jnp.asarray(xi))
    t = {k: torch.from_numpy(v) for k, v in dict(xi=xi, lp=lp, K=K, target=target).items()}
    ts = tr.bin_state(tc.se3.exp(t["xi"]), t["lp"], t["K"])
    d = t["xi"].clone().requires_grad_()
    vt = tc.mask_loss(d, tr, t["lp"], t["K"], t["target"], bin_state=ts,
                      ref_tiles=tc.tile_masks(target, tr))
    vt.backward()
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-5)
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(d.grad.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def test_probes_budget_and_metrics(rig):
    jr, tr, lp, gt, _ = rig
    assert tc.adaptive_drift_budget(tr.tile, 1.0) == jc.adaptive_drift_budget(jr.tile, 1.0)
    pj = np.asarray(jc.drift_probe_points(jr, jnp.asarray(lp)))
    pt = tc.drift_probe_points(tr, torch.from_numpy(lp))
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-6)
    xi = gt + OFFSET
    fj = jc.make_drift_probe_fn(jnp.asarray(pj), jnp.asarray(K))(jnp.asarray(xi))
    ft = tc.make_drift_probe_fn(pt, torch.from_numpy(K))(torch.from_numpy(xi))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-4)  # pixels
    Tgt = np.asarray(jse3.exp(jnp.asarray(gt)))
    mj, mt = jc.pose_metrics(xi, Tgt), tc.pose_metrics(xi, Tgt)
    assert mj.keys() == mt.keys()
    np.testing.assert_allclose([mt[k] for k in mj], [mj[k] for k in mj], atol=1e-3)


@pytest.mark.parametrize("name,clip", [("adam", 0.0), ("adam", 0.5), ("sgd", 0.0)])
def test_optimizer_matches_optax(name, clip):
    rng = np.random.default_rng(2)
    jopt = j_make_optimizer(name, max_lr=3e-3, scheduler="constant", grad_clip=clip)
    topt = t_make_optimizer(name, max_lr=3e-3, scheduler="constant", grad_clip=clip)
    p = rng.normal(size=6).astype(np.float32)
    js, ts = jopt.init(jnp.asarray(p)), topt.init(torch.from_numpy(p))
    for _ in range(5):
        g = rng.normal(size=6).astype(np.float32)
        uj, js = jopt.update(jnp.asarray(g), js, jnp.asarray(p))
        ut, ts = topt.update(torch.from_numpy(g), ts, torch.from_numpy(p))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-6, atol=1e-9)
    leaves_j = jax.tree_util.tree_leaves(js)
    leaves_t = topt.leaves(ts)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for make in (t_make_optimizer, j_make_optimizer):  # an unknown schedule name
        with pytest.raises(ValueError, match="unknown scheduler"):
            make("adam", scheduler="cosine_restarts")


def _run_jax(rig, num_steps, chunk, resume=None, hook=None):
    jr, _, lp, gt, target = rig
    return jc._calibrate_scan(
        jnp.asarray(gt + OFFSET), jnp.asarray(lp), jnp.asarray(K),
        jnp.asarray(target), jr, num_steps, 3e-3, "adam", "constant", 0.0, 1.0,
        chunk=chunk, rebin_every=0, resume_state=resume, step_hook=hook,
    )


def test_calibrate_30_steps_adaptive(rig):
    jr, tr, lp, gt, target = rig
    init = gt + OFFSET
    jres = jc.calibrate(init, jr, lp, K, target, num_steps=30, rebin_every=0)
    tres = tc.calibrate(init, tr, lp, K, target, num_steps=30, rebin_every=0)
    assert tres.rebins == jres.rebins and not tres.overflow
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tres.history, jres.history, atol=1e-4)
    np.testing.assert_allclose(tres.dof, jres.dof, atol=1e-4)
    assert tres.losses[-1] < tres.losses[0]


def test_resume_across_packages(rig):
    """A JAX step_hook state resumes in the port, and a port state in JAX,
    matching JAX's uninterrupted run (chunks of 10 steps, 20 in all)."""
    _, tr, lp, gt, target = rig
    jstates = {}
    dof_full, losses_full, _, _, _ = _run_jax(
        rig, 20, 10, hook=lambda done, s: jstates.setdefault(done, s))
    # JAX -> port
    res = tc.calibrate(gt + OFFSET, tr, lp, K, target, num_steps=20, rebin_every=0,
                       resume_state=convert.state_from_jax(jstates[10]))
    np.testing.assert_array_equal(res.losses[:10], np.asarray(losses_full)[:10])
    np.testing.assert_allclose(res.losses, np.asarray(losses_full), rtol=1e-3)
    np.testing.assert_allclose(res.dof, np.asarray(dof_full), atol=1e-4)
    # port -> JAX
    tstates = {}
    tc.calibrate(gt + OFFSET, tr, lp, K, target, num_steps=10, rebin_every=0,
                 step_hook=lambda done, s: tstates.setdefault(done, s))
    dof_j, losses_j, _, _, _ = _run_jax(
        rig, 20, 10, resume=convert.state_to_jax(tstates[10]))
    np.testing.assert_allclose(np.asarray(losses_j), np.asarray(losses_full), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(dof_j), np.asarray(dof_full), atol=1e-4)


def test_overflow_raise_warn_ignore(rig):
    # cap 32 << this scene's bin loads: every rebin overflows
    _, tr, lp, gt, target = rig
    bad = TR(tr.meshes, H, W, tile=TTC(**dict(CFG, capacity=32)), device="cpu")
    args = (gt + OFFSET, bad, lp, K, target)
    with pytest.raises(tc.BinOverflowError):
        tc.calibrate(*args, num_steps=2, rebin_every=0)
    assert tc.calibrate(*args, num_steps=2, rebin_every=0, on_overflow="warn").overflow
    assert not tc.calibrate(*args, num_steps=2, rebin_every=0, on_overflow="ignore").overflow


# ---------------------------------------------------------------------------
# The dense fused route (compact_chunks == 0, the default RenderConfig's):
# K1 loss kernels in calibrate, K4 silhouette kernels in render_outputs.
# ---------------------------------------------------------------------------

DENSE = dict(CFG, compact_chunks=0)


@pytest.fixture(scope="module")
def dense_rig(rig):
    _, tr, lp, gt, target = rig
    jr = JR(tr.meshes, H, W, tile=JTC(**DENSE))
    trd = TR(tr.meshes, H, W, tile=TTC(**DENSE), device="cpu")
    return jr, trd, lp, gt, target


def test_calibrate_30_steps_adaptive_dense(dense_rig):
    jr, tr, lp, gt, target = dense_rig
    init = gt + OFFSET
    jres = jc.calibrate(init, jr, lp, K, target, num_steps=30, rebin_every=0)
    tres = tc.calibrate(init, tr, lp, K, target, num_steps=30, rebin_every=0)
    assert tres.rebins == jres.rebins and not tres.overflow
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tres.history, jres.history, atol=1e-4)
    np.testing.assert_allclose(tres.dof, jres.dof, atol=1e-4)
    assert tres.losses[-1] < tres.losses[0]


def test_render_outputs_match(dense_rig):
    jr, tr, lp, gt, target = dense_rig
    dof = gt + OFFSET
    oj = jc.render_outputs(dof, jr, lp, K, target)
    ot = tc.render_outputs(dof, tr, lp, K, target)
    assert oj.keys() == ot.keys()
    for k in oj:
        np.testing.assert_allclose(ot[k], oj[k], atol=1e-5, err_msg=k)
    assert ot["rendered_masks"].max() == 1.0


def test_calibrate_multires_two_scales(dense_rig):
    jr, tr, lp, gt, target = dense_rig
    rj = {1: jr, 2: JR(tr.meshes, H // 2, W // 2, tile=JTC(**DENSE))}
    rt = {1: tr, 2: TR(tr.meshes, H // 2, W // 2, tile=TTC(**DENSE), device="cpu")}
    np.testing.assert_array_equal(tc.downscale_mask(target, 2), jc.downscale_mask(target, 2))
    np.testing.assert_array_equal(tc.downscale_K(K, 2), jc.downscale_K(K, 2))
    steps = {2: 8, 1: 6}
    Tgt = np.asarray(jse3.exp(jnp.asarray(gt)))
    jres = jc.calibrate_multires(gt + OFFSET, rj, lp, K, target, steps, Tc_c2b_gt=Tgt)
    tres = tc.calibrate_multires(gt + OFFSET, rt, lp, K, target, steps, Tc_c2b_gt=Tgt)
    assert tres.losses.shape == (14,)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tres.dof, jres.dof, atol=1e-4)
    np.testing.assert_allclose(tres.Tc_c2b, jres.Tc_c2b, atol=1e-5)
    assert tres.metrics.keys() == jres.metrics.keys()


# ---------------------------------------------------------------------------
# The unfused route (tile.fused=False): the silhouette through K5, autograd
# through the record pack and the triangle setup, BinState rebinning.
# ---------------------------------------------------------------------------

UNFUSED = dict(CFG, fused=False, compact_chunks=0)


@pytest.fixture(scope="module")
def unfused_rig(rig):
    _, tr, lp, gt, target = rig
    jr = JR(tr.meshes, H, W, tile=JTC(**UNFUSED))
    tru = TR(tr.meshes, H, W, tile=TTC(**UNFUSED), device="cpu")
    return jr, tru, lp, gt, target


def test_calibrate_30_steps_adaptive_unfused(unfused_rig):
    jr, tr, lp, gt, target = unfused_rig
    assert tc.reuse_bins_ok(tr) and tc.tile_masks(target, tr) is None
    init = gt + OFFSET
    jres = jc.calibrate(init, jr, lp, K, target, num_steps=30, rebin_every=0)
    tres = tc.calibrate(init, tr, lp, K, target, num_steps=30, rebin_every=0)
    assert tres.rebins == jres.rebins and not tres.overflow
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tres.history, jres.history, atol=1e-4)
    np.testing.assert_allclose(tres.dof, jres.dof, atol=1e-4)
    assert tres.losses[-1] < tres.losses[0]
    oj = jc.render_outputs(tres.dof, jr, lp, K, target)
    ot = tc.render_outputs(tres.dof, tr, lp, K, target)
    for k in oj:
        np.testing.assert_allclose(ot[k], oj[k], atol=1e-5, err_msg=k)
