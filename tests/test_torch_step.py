"""The calibration step's kernel route (easyhec_torch.ops.step, models/calib.py::
_Scan with a _KernelStep) on the CPU, where its three kernels run as their plain
PyTorch twins: each twin against what the autograd step computes, a chunk on
both routes, which calls take which route, and that the route reaches the
loss's reduction over frames, the fused loss and the optimizer through their
own functions. On the card the kernels are held
to these twins (tests/test_torch_cuda.py).

Scene: the mini arm at 48×64, 2 frames, the compact (and the dense) fused
route, as tests/test_torch_graph_step.py. Tolerances: the twins sum the same
terms as autograd in another order (the gradient J^T·dL/dTc against
autograd's chain through se3.exp), so the loss agrees to rtol 1e-6 and the
gradient to 1e-5 of its largest component; over a 10-step Adam chunk the
routes' poses part by an ulp or two, so traces and poses agree to 1e-6 of
their largest magnitude, with equal rebin counts.
"""
import tempfile

import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.geometry import se3
from easyhec_torch.models import calib as tc
from easyhec_torch.ops import pose_raster as pr
from easyhec_torch.ops import pose_raster_compact as prc
from easyhec_torch.ops import step
from easyhec_torch.parallel import make_mesh, sharded_calibrate
from easyhec_torch.render import RobotRenderer, TileConfig, fused
from easyhec_torch.render.fused import (cam_rows, loss_fused, loss_parts, silhouette_compact,
                                        tile_sq)
from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
from easyhec_torch.solver.optim import make_optimizer
from easyhec_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 48, 64
K = torch.tensor([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
LINKS = ["base", "upper", "fore"]
CFG = dict(tile_h=16, tile_w=32, capacity=256, binner="count", fused=True,
           margin=2.0, bin_big_k=128, compact_chunks=16, bwd_band_only=True)
OFFSET = torch.tensor([0.02, -0.02, 0.015, 0.01, -0.01, 0.015])


@pytest.fixture(scope="module")
def rig():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    model = parse_urdf(path)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    mesh_list = [meshes[n] for n in LINKS]
    r = RobotRenderer(mesh_list, H, W, tile=TileConfig(**CFG), device="cpu")
    qs = torch.linspace(-0.3, 0.3, 2 * chain.n_dof).reshape(2, chain.n_dof)
    lp = torch.stack([chain.fk(q) for q in qs])[:, [0, 1, 2]].float()
    Tc = torch.eye(4)
    Tc[2, 3] = 1.2
    target = (silhouette_compact(r, Tc, K, r.bin_state(Tc, lp, K)) > 0.5).float()
    return r, mesh_list, lp, se3.log(Tc), target


def _dense(mesh_list):
    cfg = {k: v for k, v in CFG.items() if k != "compact_chunks"}
    return RobotRenderer(mesh_list, H, W, tile=TileConfig(**cfg), device="cpu")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# ---------------------------------------------------------------------------
# step_head: the pose, the camera rows, the Jacobian, the probe pixels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [0.0, 1e-3, 0.1, 0.1999, 0.2001, 0.7, 2.0, 3.0])
def test_head_matches_se3_exp_and_jacrev(theta):
    """Tc is se3.exp(dof) and cam its fused.cam_rows, bit for bit; the
    analytic Jacobian equals autograd's jacrev through se3.exp (in float64,
    where roundoff does not hide a wrong term: 1e-9 of its largest entry;
    in float32 1e-5), across the Taylor branch (θ < 0.2), its edge and the
    closed forms; the probe pixels are calib.make_drift_probe_fn's."""
    rng = np.random.default_rng(int(theta * 1e4))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    dof = torch.tensor(np.concatenate([rng.normal(size=3) * 0.5, axis * theta]),
                       dtype=torch.float32)
    B = 3
    Tc, cam, jac = torch.zeros(4, 4), torch.zeros(B, 16), torch.zeros(12, 6)
    probes = torch.tensor(rng.normal(size=(7, 3)) * 0.3, dtype=torch.float32)
    pix = torch.zeros(7, 2)
    step.step_head(dof, K, Tc, cam, jac, probes, pix)
    assert torch.equal(Tc, se3.exp(dof))
    assert torch.equal(cam, cam_rows(se3.exp(dof), K, B))
    assert torch.equal(pix, tc.make_drift_probe_fn(probes, K)(dof))
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
        d = dof.to(dtype)
        want = torch.func.jacrev(lambda x: se3.exp(x)[:3, :4].reshape(12))(d)
        assert _rel(step.exp_jacobian(d), want) < tol, (dtype, theta)
    assert _rel(jac, torch.func.jacrev(lambda x: se3.exp(x)[:3, :4].reshape(12))(dof)) < 1e-5


# ---------------------------------------------------------------------------
# step_grad: [loss, g] against autograd through loss_fused
# ---------------------------------------------------------------------------


def _grad_case(r, lp, dof, target, w):
    """(the twins' [loss, g], autograd's [loss, g]) at dof, the frames
    weighted by w, on r's fused route."""
    ref_tiles = tc.tile_masks(target, r)
    k = tc._KernelStep(r, lp, K, ref_tiles, 1.0, w)
    st = r.bin_state(se3.exp(dof), lp, K)
    Tc, cam, jac, gl = torch.zeros(4, 4), torch.zeros(2, 16), torch.zeros(12, 6), torch.zeros(7)
    step.step_head(dof, K, Tc, cam, jac)
    lparts, parts, counts = loss_parts(r, cam, st, k.ref_tiles, k.w)
    step.step_grad(parts, lparts, counts, k.ref_sq, k.w, jac, gl, k.work)
    d = dof.clone().requires_grad_(True)
    loss = torch.sum(loss_fused(r, se3.exp(d), lp, K, state=st, ref_tiles=ref_tiles) * w)
    (g,) = torch.autograd.grad(loss, d)
    return gl, torch.cat([loss.detach().reshape(1), g])


@pytest.mark.parametrize("route", ["compact", "dense"])
@pytest.mark.parametrize("weights", ["mean", "rig"])
def test_grad_matches_autograd_through_loss_fused(rig, route, weights):
    """The head, the fused loss kernels called directly (the backward under
    the frames' weights) and step_grad give autograd's loss and gradient
    through loss_fused: the mean of calibrate (weights 1/B) and a mesh
    shard's weighted sum (weights 1 and 0, a padded frame); on the compact
    route with the empty tiles' Σ ref² from the per-call ref_sq."""
    r, mesh_list, lp, gt, target = rig
    if route == "dense":
        r = _dense(mesh_list)
    w = torch.tensor([0.5, 0.5]) if weights == "mean" else torch.tensor([1.0, 0.0])
    for off in (OFFSET, -0.5 * OFFSET):
        got, want = _grad_case(r, lp, gt + off, target, w)
        np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-6)
        assert _rel(got[1:], want[1:]) < 1e-5


def test_ref_sq_is_the_empty_tiles_term(rig):
    """The per-call Σ ref² per tile gives loss_fused's empty-tile term: with
    every tile marked empty, step_grad's loss is Σ_b w_b Σ_t ref_sq."""
    r, _, lp, gt, target = rig
    ref_tiles = tc.tile_masks(target, r)
    ref_sq = tile_sq(ref_tiles)
    w = torch.tensor([0.5, 0.5])
    gl = torch.zeros(7)
    counts = torch.zeros(ref_sq.shape, dtype=torch.int32)
    step.step_grad(torch.zeros(2, 3, 12), torch.zeros(2, ref_sq.shape[1], 1), counts, ref_sq,
                   w, torch.zeros(12, 6), gl, None)
    assert gl[0].item() == pytest.approx(float(target.sum()) / 2, rel=1e-6)
    assert torch.equal(gl[1:], torch.zeros(6))


# ---------------------------------------------------------------------------
# step_update: make_optimizer's update, the traces, the flag
# ---------------------------------------------------------------------------

OPTIONS = {
    "adam": dict(name="adam"),
    "sgd": dict(name="sgd"),
    "clip": dict(name="adam", grad_clip=0.5),
    "clip_value": dict(name="adam", grad_clip_value=0.2),
    "weight_decay": dict(name="adam", weight_decay=0.1, weight_decay_bias=0.1),
    "warmup_cosine": dict(name="adam", scheduler="warmup_cosine", warmup_steps=3),
}


def _spec_update(spec, g, leaves, x):
    """The update kernel's arithmetic (csrc/step.cu) from the optimizer's
    spec alone, in float32 numpy: -> (update, new leaves)."""
    f = np.float32
    g = g.astype(f)
    if spec.grad_clip > 0:
        norm = np.sqrt(np.sum(g * g, dtype=f))
        if not norm < f(spec.grad_clip):
            g = (g / norm) * f(spec.grad_clip)
    if spec.grad_clip_value > 0:
        g = np.clip(g, -f(spec.grad_clip_value), f(spec.grad_clip_value))
    sched = int(leaves[-1])
    lr = spec.lr
    if lr is None:
        lr = float(spec.sched(torch.tensor(sched, dtype=torch.int32)))
    if spec.adam:
        count = int(leaves[0]) + 1
        mu = f(1 - spec.b1) * g + f(spec.b1) * leaves[1]
        nu = f(1 - spec.b2) * (g * g) + f(spec.b2) * leaves[2]
        c1, c2 = f(1) - f(spec.b1) ** f(count), f(1) - f(spec.b2) ** f(count)
        u = (mu / c1) / (np.sqrt(nu / c2) + f(spec.eps))
        if spec.weight_decay:
            u = u + f(spec.weight_decay) * x
        return -f(lr) * u, [count, mu, nu, sched + 1]
    tr = g + f(spec.momentum) * leaves[0]
    return -f(lr) * tr, [tr, sched + 1]


@pytest.mark.parametrize("option", list(OPTIONS))
def test_update_matches_make_optimizer(option):
    """Eight steps of step_update against make_optimizer's update of a bare
    tensor (the autograd step's): the pose, the leaves, the traces at the
    step index (the pose before each update, loss = gl[0] / den) and the
    cadence flag equal bit for bit; the update kernel's arithmetic, written
    from the optimizer's spec alone, agrees to 1e-6 (rtol), so the spec
    carries every constant the kernel reads."""
    kw = dict(OPTIONS[option])
    opt = make_optimizer(kw.pop("name"), max_lr=3e-3, total_steps=20, **kw)
    assert opt.spec is not None and opt.spec.adam == (option != "sgd")
    rng = np.random.default_rng(1)
    dof = torch.tensor(rng.normal(size=6), dtype=torch.float32)
    ref_dof, ref_state = dof.clone(), opt.init(dof)
    leaves = [t.clone() for t in opt.leaves(ref_state)]
    n = 8
    losses, history = torch.zeros(n), torch.zeros(n, 6)
    idx, inner = torch.zeros(1, dtype=torch.int64), torch.tensor(3)
    need = torch.zeros((), dtype=torch.bool)
    den = 4.0
    for i in range(n):
        gl = torch.tensor(rng.normal(size=7), dtype=torch.float32)
        want_u, want_leaves = _spec_update(opt.spec, (gl[1:] / den).numpy(),
                                           [t.numpy().copy() for t in leaves], dof.numpy())
        step.step_update(gl, den, opt, leaves, dof, losses, history, idx, need, inner)
        u, ref_state = opt.update(gl[1:] / den, ref_state, ref_dof)
        assert torch.equal(history[i], ref_dof) and losses[i] == gl[0] / den
        ref_dof = ref_dof + u
        assert torch.equal(dof, ref_dof)
        for a, b in zip(leaves, opt.leaves(ref_state)):
            assert torch.equal(a, b)
        np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-6, atol=1e-12)
        for a, b in zip(leaves, want_leaves):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
        assert int(idx) == i + 1 and bool(need) == ((i + 1) % 3 == 0)


def test_update_drift_flag_reads_zero_at_the_build_pose():
    """The adaptive flag: the probes' pixels under exp(new pose) against the
    state's build pixels (the head's), past the budget. Built at the pose
    the update reaches, the drift reads exactly 0 (no rebin even at budget
    0); built at the pose before the update, the flag is set below the
    probes' real move and clear above it."""
    opt = make_optimizer("adam", max_lr=3e-3, total_steps=10)
    dof = torch.tensor([0.01, -0.02, 1.2, 0.03, 0.02, -0.01])
    probes = torch.tensor(np.random.default_rng(2).normal(size=(20, 3)) * 0.2,
                          dtype=torch.float32)
    gl = torch.tensor([1.0, 0.3, -0.2, 0.1, 0.05, -0.4, 0.2])
    leaves = list(opt.leaves(opt.init(dof)))

    def update(pix=None, budget=0.0):
        d = dof.clone()
        need = torch.zeros((), dtype=torch.bool)
        step.step_update(gl, 1.0, opt, [t.clone() for t in leaves], d, torch.zeros(1),
                         torch.zeros(1, 6), torch.zeros(1, dtype=torch.int64), need,
                         torch.tensor(1), None if pix is None else (probes, K, pix, budget))
        return d, bool(need)

    def head_pix(d):
        pix = torch.zeros(20, 2)
        step.step_head(d, K, torch.zeros(4, 4), torch.zeros(1, 16), torch.zeros(12, 6), probes,
                       pix)
        return pix

    after, _ = update()
    d, need = update(head_pix(after), 0.0)
    assert torch.equal(d, after) and not need
    before = head_pix(dof)
    moved = float((step.project_probes(probes, se3.exp(after), K) - before).abs().max())
    assert moved > 1e-3
    assert update(before, 0.5 * moved)[1] and not update(before, 2.0 * moved)[1]


# ---------------------------------------------------------------------------
# The routes: a chunk on both, and which calls take which
# ---------------------------------------------------------------------------


def _scan(rig, chunk, rebin_every, kernel, monkeypatch, **kw):
    r, _, lp, gt, target = rig
    if not kernel:
        monkeypatch.setattr(tc, "_kernel_route", lambda *a: False)
    opt = make_optimizer("adam", max_lr=3e-3, total_steps=chunk)
    d0 = gt + OFFSET
    scan = tc._chunk_scan(d0, opt.init(d0), opt, lp, K, target, tc.tile_masks(target, r), r,
                          chunk, 1.0, kw.get("robust_delta", 0.0), rebin_every)
    monkeypatch.undo()
    return scan


@pytest.mark.parametrize("rebin_every", [0, 3], ids=["adaptive", "every3"])
def test_chunk_matches_the_autograd_route(rig, rebin_every, monkeypatch):
    """A 10-step chunk on the kernel route (the twins) and on the autograd
    route (_kernel_route refusing): losses, history and pose agree to 1e-6
    of their largest magnitude, the Adam count and the rebins equal, and
    kernel_steps counts the steps run (12 on the fixed cadence: four whole
    windows), 0 on the autograd route."""
    out = {}
    for kernel in (True, False):
        scan = _scan(rig, 10, rebin_every, kernel, monkeypatch)
        assert (scan.kernel is not None) == kernel
        out[kernel] = scan.run(10), scan.kernel_steps
    (a, ka), (b, kb) = out[True], out[False]
    steps = 12 if rebin_every == 3 else 10
    assert (ka, kb) == (steps, 0)
    assert a[5] == b[5] and a[4] == b[4] is False
    assert int(a[1][0]) == int(b[1][0]) == steps
    for x, y in ((a[2], b[2]), (a[3], b[3]), (a[0], b[0])):
        assert _rel(x, y) < 1e-6


def _half_batch(m):
    real = tc._robust_mean
    m.setattr(tc, "_robust_mean", lambda pf, masks, d: real(pf[:1], masks[:1], d))


def _scaled_loss(m):
    real = fused.loss_fused
    m.setattr(fused, "loss_fused", lambda *a, **k: real(*a, **k) * 1.001)


REPLACED = {"half_batch": _half_batch, "scaled_loss": _scaled_loss}


def _replaced_chunk(rig, kernel, replace):
    """A 10-step adaptive chunk with ``replace`` applied while it is built
    and run, on the kernel route or the autograd route."""
    r, _, lp, gt, target = rig
    with pytest.MonkeyPatch.context() as m:
        replace(m)
        if not kernel:
            m.setattr(tc, "_kernel_route", lambda *a: False)
        opt = make_optimizer("adam", max_lr=3e-3, total_steps=10)
        d0 = gt + OFFSET
        scan = tc._chunk_scan(d0, opt.init(d0), opt, lp, K, target, tc.tile_masks(target, r),
                              r, 10, 1.0, 0.0, 0)
        assert (scan.kernel is not None) == kernel
        return scan.run(10)


@pytest.mark.parametrize("replaced", list(REPLACED))
def test_kernel_route_calls_the_reduction_and_the_loss(rig, replaced):
    """The kernel route takes its frames' weights from calibrate's reduction
    over frames (the gradient of _robust_mean) and its [loss, g] from
    render/fused.py::loss_fused, looked up when used: with either replaced
    (the mean over the first frame alone; the loss times 1.001) a 10-step
    chunk on the kernel route tracks the autograd route under the same
    replacement to 1e-6 of the largest magnitude, and leaves the chunk of
    neither replacement by more than 1e-4."""
    plain = _replaced_chunk(rig, True, lambda m: None)
    a = _replaced_chunk(rig, True, REPLACED[replaced])
    b = _replaced_chunk(rig, False, REPLACED[replaced])
    for x, y in ((a[2], b[2]), (a[3], b[3]), (a[0], b[0])):
        assert _rel(x, y) < 1e-6
    assert _rel(a[2], plain[2]) > 1e-4


def test_a_wrapped_optimizer_keeps_its_own_update(rig, monkeypatch):
    """An optimizer that is not make_optimizer's own Optimizer (here one that
    passes every attribute through, its spec too, but zeroes its updates)
    keeps the autograd step, which applies its ``update``: calibrate's pose
    stays where it started and ``kernel_steps`` reads 0."""
    r, _, lp, gt, target = rig
    real = tc.make_optimizer

    class Frozen:
        def __init__(self, opt):
            self.opt = opt

        def __getattr__(self, name):
            return getattr(self.opt, name)

        def update(self, g, state, params):
            u, s = self.opt.update(g, state, params)
            return torch.zeros_like(u), s

    monkeypatch.setattr(tc, "make_optimizer", lambda *a, **k: Frozen(real(*a, **k)))
    init = (gt + OFFSET).numpy()
    profiling.clear()
    res = tc.calibrate(init, r, lp, K, target, num_steps=4, rebin_every=0)
    (call,) = [s for s in profiling.spans() if s.name == "calib.call"]
    assert call.counts["kernel_steps"] == 0
    np.testing.assert_array_equal(res.dof, init)


ROUTES = {  # name: (renderer, optimizer, calibrate's keywords, kernel route)
    "compact adam": ("compact", dict(name="adam"), {}, True),
    "compact sgd": ("compact", dict(name="sgd"), {}, True),
    "compact adam clip, warmup_cosine": (
        "compact", dict(name="adam", grad_clip=1.0, scheduler="warmup_cosine"), {}, True),
    "dense adam": ("dense", dict(name="adam"), {}, True),
    "compact every 3": ("compact", dict(name="adam"), dict(rebin_every=3), True),
    "unfused (K5)": ("unfused", dict(name="adam"), {}, False),
    "huber (robust_delta > 0)": ("compact", dict(name="adam"), dict(robust_delta=0.2), False),
    "bias groups": ("compact", dict(name="adam", bias_lr_factor=2.0), {}, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_table(rig, case):
    """Which calls take the kernel route: the fused loss (compact or dense,
    any rebin cadence), no Huber weights, make_optimizer's adam or sgd with
    one parameter group, any schedule or clip. The unfused route, the Huber
    loss and parameter groups keep the autograd step. calibrate's span
    ``calib.call`` counts the kernel route's steps."""
    r, mesh_list, lp, gt, target = rig
    kind, okw, ckw, want = ROUTES[case]
    if kind == "dense":
        r = _dense(mesh_list)
    elif kind == "unfused":
        cfg = {k: v for k, v in CFG.items() if k not in ("compact_chunks", "fused")}
        r = RobotRenderer(mesh_list, H, W, tile=TileConfig(**cfg), device="cpu")
    okw = dict(okw)
    opt = make_optimizer(okw.pop("name"), max_lr=3e-3, total_steps=4, **okw)
    assert tc._kernel_route(r, opt, ckw.get("robust_delta", 0.0)) == want
    if "bias_lr_factor" in okw:  # calibrate builds its own optimizer: the rule alone
        assert opt.spec is None
        return
    profiling.clear()
    res = tc.calibrate((gt + OFFSET).numpy(), r, lp, K, target, num_steps=4,
                       optimizer="sgd" if case == "compact sgd" else "adam",
                       scheduler=okw.get("scheduler", "constant"),
                       grad_clip=okw.get("grad_clip", 0.0), rebin_every=ckw.get("rebin_every", 0),
                       robust_delta=ckw.get("robust_delta", 0.0))
    (call,) = [s for s in profiling.spans() if s.name == "calib.call"]
    steps = 6 if ckw.get("rebin_every") == 3 else 4  # whole windows of 3
    assert call.counts["kernel_steps"] == (steps if want else 0)
    assert np.isfinite(res.losses).all() and res.losses.shape == (4,)


def test_sharded_local_mesh_takes_the_kernel_route(rig):
    """sharded_calibrate on the (1, 1) mesh of a process without a process
    group: the kernel route with the frames' weights 1 and the real-frame
    count as ``den`` (shard.call's kernel_steps equal the steps), tracking
    calibrate's kernel route (weights 1/B) to 1e-5 of the largest loss and
    1e-6 of the pose over 20 steps."""
    r, _, lp, gt, target = rig
    init = (gt + OFFSET).numpy()
    ref = tc.calibrate(init, r, lp, K, target, num_steps=20, rebin_every=0)
    profiling.clear()
    dof, losses, history = sharded_calibrate(init, r, make_mesh(1, 1), lp.numpy(), K.numpy(),
                                             target.numpy(), num_steps=20, rebin_every=0)
    (call,) = [s for s in profiling.spans() if s.name == "shard.call"]
    assert call.counts["kernel_steps"] == 20
    assert _rel(losses, torch.from_numpy(ref.losses)) < 1e-5
    assert _rel(dof, torch.from_numpy(ref.dof)) < 1e-6


def test_fused_kernels_count_no_launch_on_the_cpu(rig, monkeypatch):
    """On CPU tensors the kernel route takes the twins: no wrapper of
    ops/step.py, ops/pose_raster.py or ops/pose_raster_compact.py counts a
    launch."""
    wrappers = (step.step_head_cuda, step.step_grad_cuda, step.step_update_cuda,
                prc.loss_fwd_compact_cuda, prc.loss_bwd_compact_cuda, pr.loss_fwd_cuda)
    before = [f.launches for f in wrappers]
    scan = _scan(rig, 3, 0, True, monkeypatch)
    scan.run(3)
    assert [f.launches for f in wrappers] == before and scan.kernel_steps == 3
