"""The calibration step over static buffers (easyhec_torch.models.calib._Scan:
a turn is the rebin where the device flag is set, then the step), run eagerly
on the CPU
against the JAX package's compiled chunk (easyhec_tpu.models.calib.
_calibrate_chunk and opt_scan, Pallas in interpret mode), and, on stub
graphs, how easyhec_torch.utils.cuda_graph.CondGraph captures the
conditional rebin and how replays advance the launch counters.

Scene: the mini arm at 48×64, the compact fused route, 2 frames. Tolerances
are tests/test_torch_calib.py's: over an Adam trajectory the loss trace is
held to rtol 1e-3 and history and pose to atol 1e-4, with equal rebin counts
and overflow flags. On the card the same step runs as one captured graph
with the rebin as its conditional node, held bit for bit against this eager
runner (tests/test_torch_cuda.py).
"""
import contextlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.models import calib as tc
from easyhec_torch.ops import pose_raster_compact as prc
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.render.fused import silhouette_compact
from easyhec_torch.solver.optim import make_optimizer as t_make_optimizer
from easyhec_torch.utils import cuda_graph
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
LR = 3e-3


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
    qs = jnp.linspace(-0.3, 0.3, 2 * chain.n_dof).reshape(2, chain.n_dof)
    lp = np.array(jax.vmap(chain.fk)(qs)[:, jnp.asarray([0, 1, 2])])
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    gt = np.asarray(jse3.log(jnp.asarray(Tc)))
    args = (torch.from_numpy(Tc), torch.from_numpy(lp), torch.from_numpy(K))
    target = (silhouette_compact(tr, args[0], args[2], tr.bin_state(*args)) > 0.5)
    return jr, tr, lp, gt, target.float().numpy()


def _port_scan(rig, chunk, rebin_every):
    """_chunk_scan as calibrate sets it up: no capture, since
    utils.cuda_graph.captures says no on the CPU; the kernel route (the
    compact fused loss and Adam), its kernels' plain twins running."""
    _, tr, lp, gt, target = rig
    opt = t_make_optimizer("adam", max_lr=LR, total_steps=chunk)
    d0 = torch.from_numpy(gt + OFFSET)
    scan = tc._chunk_scan(d0, opt.init(d0), opt, torch.from_numpy(lp), torch.from_numpy(K),
                          torch.from_numpy(target), tc.tile_masks(target, tr), tr, chunk,
                          1.0, 0.0, rebin_every)
    assert not cuda_graph.captures(d0.device) and scan.graph is None
    assert scan.kernel is not None
    return scan


def _check_chunk(port, jax_out, n_leaves=4):
    dof, st, losses, hist, ov, nrb = port
    jdof, jst, jl, jh, jov, jnrb = jax_out
    assert nrb == int(jnrb) and ov == bool(jov) and not ov
    assert losses.shape == jl.shape and hist.shape == jh.shape
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-3)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(dof.numpy(), np.asarray(jdof), atol=1e-4)
    leaves_j = jax.tree_util.tree_leaves(jst)
    assert len(leaves_j) == len(st) == n_leaves
    assert int(st[0]) == int(leaves_j[0])  # Adam's count: the steps run


@pytest.mark.parametrize("rebin_every", [0, 3], ids=["adaptive", "every3"])
def test_chunk_matches_jax_calibrate_chunk(rig, rebin_every):
    """One chunk of 10 steps, adaptive (a rebin whenever the probes drift
    past the budget, tested on the device at each step's end) or at a fixed
    cadence of 3 (four windows: 12 steps run, the trace cut to 10)."""
    jr, _, lp, gt, target = rig
    chunk = 10
    jopt = j_make_optimizer("adam", max_lr=LR, total_steps=chunk)
    d0 = jnp.asarray(gt + OFFSET)
    jout = jc._calibrate_chunk(d0, jopt.init(d0), jnp.asarray(lp), jnp.asarray(K),
                               jnp.asarray(target), jr, chunk, chunk, LR, "adam",
                               "constant", 0.0, 1.0, 0.0, rebin_every)
    scan = _port_scan(rig, chunk, rebin_every)
    out = scan.run(chunk)
    _check_chunk(out, jout)
    steps = 12 if rebin_every == 3 else chunk
    assert int(scan.bufs["idx"]) == steps and int(out[1][0]) == steps
    if rebin_every == 3:
        assert out[5] == 4
    else:
        assert out[5] >= 2  # the start's state and at least one drift rebin


def test_opt_scan_without_bin_states_matches_jax(rig):
    """rebin_every < 1: no bin state (the loss builds its own each step),
    through each package's public opt_scan."""
    jr, tr, lp, gt, target = rig
    chunk = 8
    jopt = j_make_optimizer("adam", max_lr=LR, total_steps=chunk)
    topt = t_make_optimizer("adam", max_lr=LR, total_steps=chunk)
    jt = dict(lp=jnp.asarray(lp), K=jnp.asarray(K), m=jnp.asarray(target))
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in jt.items()}

    def j_loss(d, state):
        assert state is None
        return jc.mask_loss(d, jr, jt["lp"], jt["K"], jt["m"], bin_state=state)

    def t_loss(d, state):
        assert state is None
        return tc.mask_loss(d, tr, tt["lp"], tt["K"], tt["m"], bin_state=state)

    d0 = gt + OFFSET
    jout = jc.opt_scan(jnp.asarray(d0), jopt.init(jnp.asarray(d0)), jopt, j_loss, None,
                       chunk, 0)
    tout = tc.opt_scan(torch.from_numpy(d0), topt.init(torch.from_numpy(d0)), topt, t_loss,
                       None, chunk, 0)
    _check_chunk(tout, jout)
    assert tout[5] == 0


def test_step_index_fills_traces_across_a_short_last_chunk(rig):
    """53 steps in chunks of 50 and 3 through one _Scan (calibrate's loop):
    the device step index restarts at each chunk, writes the 3 entries of
    the last chunk in order and leaves the rest of the [50] buffers as the
    first chunk wrote them; the traces match JAX's 53-step run (the losses
    to rtol 1e-3 above a floor of 1e-6 of the largest)."""
    jr, tr, lp, gt, target = rig
    jdof, jl, jh, jov, jrb = jc._calibrate_scan(
        jnp.asarray(gt + OFFSET), jnp.asarray(lp), jnp.asarray(K), jnp.asarray(target), jr,
        53, LR, "adam", "constant", 0.0, 1.0, chunk=50, rebin_every=0)
    scan = _port_scan(rig, 50, 0)
    bufs = scan.bufs
    assert bufs["losses"].shape == (50,)
    a = scan.run(50)
    first = bufs["losses"].clone()
    b = scan.run(3)
    assert int(bufs["idx"]) == 3
    assert torch.equal(bufs["losses"][:3], b[2]) and torch.equal(bufs["history"][:3], b[3])
    assert torch.equal(bufs["losses"][3:], first[3:])
    # near the optimum the loss falls to ~1e-6 of its start, where rtol
    # 1e-3 is below its float noise: a floor of 1e-6 of the largest loss
    jl = np.asarray(jl)
    np.testing.assert_allclose(torch.cat([a[2], b[2]]).numpy(), jl, rtol=1e-3,
                               atol=1e-6 * jl.max())
    np.testing.assert_allclose(torch.cat([a[3], b[3]]).numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(jdof), atol=1e-4)
    assert a[5] + b[5] == jrb and not (a[4] or b[4] or jov)
    # calibrate's own loop gives the same trace
    _, losses, hist, ov, rebins = tc._calibrate_scan(
        torch.from_numpy(gt + OFFSET), torch.from_numpy(lp), torch.from_numpy(K),
        torch.from_numpy(target), tr, 53, LR, "adam", "constant", 0.0, 1.0, chunk=50,
        rebin_every=0)
    assert torch.equal(losses, torch.cat([a[2], b[2]])) and rebins == jrb and not ov


@pytest.mark.parametrize("mode", ["every3", "adaptive", "stateless"])
def test_eager_turn_rebins_where_the_flag_is_set(mode):
    """_Scan's eager turns on a toy quadratic: the step's tail leaves the
    next turn's rebin flag, and the turn rebins only where it is set. A
    fixed cadence of 3 over a chunk of 7 runs three whole windows (9 steps,
    the trace cut to 7) and rebins at steps 0, 3 and 6; adaptive rebins at
    step 0 and wherever the probes drifted past the budget from the last
    build pose; a scan without bin states never builds one."""
    target = torch.tensor([1.0, -2.0, 0.5, 0.0, 0.3, -0.1])
    builds = []

    class State:
        overflow = torch.zeros((), dtype=torch.bool)

    def bin_state_of(d):
        builds.append(d.clone())
        return State()

    def loss_of(d, state):
        assert (state is None) == (mode == "stateless")
        return torch.sum((d - target) ** 2)

    def probe(d):
        return d[:2] * 10.0

    every, budget = {"every3": (3, 0.0), "adaptive": (1, 1.5), "stateless": (0, 0.0)}[mode]
    opt = t_make_optimizer("adam", max_lr=0.1, total_steps=100)
    d0 = torch.zeros(6)
    scan = tc._Scan(d0, opt.init(d0), opt, loss_of, bin_state_of, tc._trace_len(7, every),
                    every, probe_fn=probe if mode == "adaptive" else None, drift_budget=budget)
    assert scan.graph is None
    dof, _, losses, history, ov, nrb = scan.run(7)
    assert losses.shape == (7,) and not ov and nrb == len(builds)
    assert losses[-1] < losses[0]
    if mode == "every3":
        want = [0, 3, 6]
    elif mode == "adaptive":
        want, last = [0], history[0]
        for i in range(1, 7):
            if torch.max(torch.abs(probe(history[i]) - probe(last))) > budget:
                want.append(i)
                last = history[i]
        assert 1 < len(want) < 7
    else:
        want = []
    assert len(builds) == len(want)
    for b, i in zip(builds, want):
        assert torch.equal(b, history[i])


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay runs no Python."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return "pool"


def test_graph_replays_advance_the_launch_counters(monkeypatch):
    """A capture records how far the wrappers' Python counters moved and
    takes it back (nothing ran); each replay adds it again. The warmup's
    launches are taken back too."""
    pools = []

    @contextlib.contextmanager
    def stub_capture(graph, pool=None):
        pools.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", stub_capture)

    class Explorer:
        last_bin_states = 0

    ex = Explorer()
    counters = cuda_graph.Counters.kernels((ex, "last_bin_states"))
    assert (prc.loss_fwd_compact_cuda, "launches") in counters.slots
    f0, b0 = prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches

    def step():  # what one captured step's wrappers count
        prc.loss_fwd_compact_cuda.launches += 1
        prc.loss_bwd_compact_cuda.launches += 1
        ex.last_bin_states += 2

    moved = counters.moved_by(step)  # the warmup's bookkeeping
    assert sum(moved) == 4 and counters.read()[-1] == 0
    g = cuda_graph.Graph(step, counters, pool="shared")
    assert pools == ["shared"]
    assert (prc.loss_fwd_compact_cuda.launches, ex.last_bin_states) == (f0, 0)
    for _ in range(5):
        g.replay()
    assert g.graph.replays == 5
    assert prc.loss_fwd_compact_cuda.launches == f0 + 5
    assert prc.loss_bwd_compact_cuda.launches == b0 + 5
    assert ex.last_bin_states == 10
    prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches = f0, b0


def test_repeat_warms_up_on_copies_then_replays(monkeypatch):
    """utils.cuda_graph.repeat (the search's stages, find_lr's step and the
    explorer's batch): captured, fn runs once on copies of the buffers (the
    warm-up, through the one routine utils.cuda_graph.capture), once on the
    buffers themselves inside the capture (in the given pool), and the
    graph replays n times, adding fn's counter movement each time (the
    kernel wrappers' counters and the caller's extra slot); not captured,
    fn runs n times on the buffers, eagerly."""
    pools, seen, warm = [], [], []

    @contextlib.contextmanager
    def stub_capture(graph, pool=None):
        pools.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", stub_capture)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(cuda_graph, "warm_up",
                        lambda fn, counters, dev: warm.append(counters.moved_by(fn)))

    class Holder:
        launches = 0

    h = Holder()
    bufs = dict(x=torch.zeros(2), leaves=[torch.ones(3)])

    def fn(b):
        seen.append((b["x"], b["leaves"][0]))
        b["x"] += 1
        h.launches += 2

    g = cuda_graph.repeat(fn, bufs, 4, True, (h, "launches"), pool="p")
    assert g.counters.slots[-1] == (h, "launches")
    assert (prc.loss_fwd_compact_cuda, "launches") in g.counters.slots
    assert [w[-1] for w in warm] == [2] and sum(warm[0]) == 2
    assert pools == ["p"] and g.graph.replays == 4
    (wx, wl), (cx, cl) = seen
    assert wx is not bufs["x"] and wl is not bufs["leaves"][0]
    assert cx is bufs["x"] and cl is bufs["leaves"][0]
    assert h.launches == 8 and g.moved[-1] == 2 and sum(g.moved) == 2
    seen.clear()
    assert cuda_graph.repeat(fn, bufs, 3, False) is None
    assert len(seen) == 3 and all(x is bufs["x"] for x, _ in seen)
    assert torch.equal(bufs["x"], torch.full((2,), 4.0)) and h.launches == 14


@pytest.mark.parametrize("mode", ["every3", "stateless"])
def test_scan_captures_through_the_one_routine(monkeypatch, mode):
    """_Scan.capture goes through utils.cuda_graph.capture, as repeat does:
    the rebin and the step run once on copies of the scan's buffers (the
    warm-up, which leaves the buffers as they were: the pose, the step
    index, the rebin count, no bin state), then are captured on the buffers
    themselves, as CondGraph(need, _rebin, _step), the body first; a scan
    without bin states captures Graph(_step) in the given pool."""
    warm, builds = [], []
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(cuda_graph, "warm_up",
                        lambda fn, counters, dev: warm.append(counters.moved_by(fn)))
    made = []

    class Graph:
        def __init__(self, fn, counters, pool=None):
            made.append(("graph", pool))
            fn()  # a capture on the CPU: the Python runs once

    class CondGraph:
        def __init__(self, flag, body, tail, counters):
            made.append(("cond", flag))
            body()
            tail()

    monkeypatch.setattr(cuda_graph, "Graph", Graph)
    monkeypatch.setattr(cuda_graph, "CondGraph", CondGraph)

    class State:
        overflow = torch.zeros((), dtype=torch.bool)

    def bin_state_of(d):
        builds.append(d)
        return State()

    def loss_of(d, state):
        assert (state is None) == (mode == "stateless")
        return torch.sum((d - 1.0) ** 2)

    every = 3 if mode == "every3" else 0
    opt = t_make_optimizer("adam", max_lr=0.1, total_steps=10)
    d0 = torch.zeros(6)
    scan = tc._Scan(d0, opt.init(d0), opt, loss_of, bin_state_of, 6, every)
    bufs = scan.bufs
    scan.capture(pool="p")
    assert len(warm) == 1 and sum(warm[0]) == 0
    if mode == "every3":
        assert made == [("cond", bufs["need"])]
        (w, c) = builds
        assert w is not bufs["dof"] and c is bufs["dof"]  # the warm-up's copy, then the buffer
        assert isinstance(bufs["state"], State) and int(bufs["nrb"]) == 1
    else:
        assert made == [("graph", "p")] and builds == [] and "state" not in bufs
    assert int(bufs["idx"]) == 1  # one step: the capture's, not the warm-up's
    assert not torch.equal(bufs["dof"], d0)


class _StubRawGraph(_StubGraph):
    """_StubGraph that takes keep_graph (the conditional node's parts)."""

    def __init__(self, keep_graph=False):
        super().__init__()
        self.keep_graph = keep_graph


class _StubCondExec:
    """Stands in for cuda_graph._CondExec: records its parts and launches."""

    def __init__(self, flag, body, tail):
        self.parts, self.launches = (flag, body, tail), 0

    def launch(self):
        self.launches += 1


def _stub_conditional(monkeypatch):
    """Stub graphs, captures and the conditional exec; -> the list of
    (graph, pool) captures in the order they ran."""
    captures = []

    @contextlib.contextmanager
    def stub_capture(graph, pool=None):
        captures.append((graph, pool))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubRawGraph)
    monkeypatch.setattr(torch.cuda, "graph", stub_capture)
    monkeypatch.setattr(cuda_graph, "_CondExec", _StubCondExec)
    return captures


def test_conditional_body_counts_once_per_taken_branch(monkeypatch):
    """A step graph with the rebin as its conditional node
    (CondGraph(need, rebin, step)): the body is captured first, then the
    tail in the body's pool, both as raw graphs; a replay launches the
    conditional exec (set kernel, IF body, tail). The capture keeps the
    body's counter movement apart from the step's: a replay adds the step's,
    taken(n) adds the body's n times (the rebin count the host reads once
    per chunk); K3 runs in the compact rebin, so the compact forward's
    counter moves in both parts."""
    captures = _stub_conditional(monkeypatch)
    counters = cuda_graph.Counters.kernels()
    f0, b0 = prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches
    need = torch.ones((), dtype=torch.bool)
    bodies = []

    def rebin():  # K3 twice, as a rebin of two tile passes would
        bodies.append(1)
        prc.loss_fwd_compact_cuda.launches += 2

    def step():
        prc.loss_fwd_compact_cuda.launches += 1
        prc.loss_bwd_compact_cuda.launches += 1

    try:
        g = cuda_graph.CondGraph(need, rebin, step, counters)
        assert len(bodies) == 1  # captured once
        (body, p0), (tail, p1) = captures
        assert body.keep_graph and tail.keep_graph and p0 is None and p1 == "pool"
        assert g.exec.parts == (need, body, tail)
        assert (prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches) \
            == (f0, b0)
        i = counters.slots.index((prc.loss_fwd_compact_cuda, "launches"))
        assert g.moved[i] == 1 and g.body_moved[i] == 2 and sum(g.body_moved) == 2
        for _ in range(7):
            g.replay()
        assert g.exec.launches == 7 and body.replays == tail.replays == 0
        g.taken(3)
        assert prc.loss_fwd_compact_cuda.launches == f0 + 7 + 3 * 2
        assert prc.loss_bwd_compact_cuda.launches == b0 + 7
        g.taken(0)
        assert prc.loss_fwd_compact_cuda.launches == f0 + 13
    finally:
        prc.loss_fwd_compact_cuda.launches, prc.loss_bwd_compact_cuda.launches = f0, b0


def test_missing_conditional_nodes_raise_naming_the_versions(monkeypatch):
    """No fallback to a host read: where torch.cuda.CUDAGraph cannot keep
    its raw graph, or the driver refuses the conditional node, a CondGraph
    raises, naming torch's and CUDA's versions."""
    real_cond_exec = cuda_graph._CondExec
    _stub_conditional(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)  # no keep_graph
    counters = cuda_graph.Counters([])
    need = torch.ones((), dtype=torch.bool)
    ran = []
    versions = f"torch {torch.__version__}, CUDA {torch.version.cuda}"
    with pytest.raises(RuntimeError, match="no keep_graph") as e:
        cuda_graph.CondGraph(need, lambda: ran.append(1), lambda: None, counters)
    assert versions in str(e.value) and not ran

    class Lib:  # graph_cond.cu's C interface, with a driver that refuses the node
        def cond_graph_build(self, *args):
            return 801

        def cond_error_string(self, rc):
            return b"operation not supported"

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubRawGraph)
    monkeypatch.setattr(_StubRawGraph, "raw_cuda_graph", lambda self: 0, raising=False)
    monkeypatch.setattr(cuda_graph, "_CondExec", real_cond_exec)
    monkeypatch.setattr(cuda_graph, "_lib", Lib)
    with pytest.raises(RuntimeError, match=r"error 801 \(operation not supported\)") as e:
        cuda_graph.CondGraph(need, lambda: ran.append(1), lambda: None, counters)
    assert versions in str(e.value) and ran == [1]  # captured, then refused
