"""The port's span recorder (easyhec_torch.utils.profiling): the ring, the
nesting, the counts, the spans of calibrate, explore and the global search
on the CPU, and the device spans, which do nothing off CUDA.

The tests marked ``cuda`` need an NVIDIA GPU and skip without one; this file
imports no JAX, so on the card run them with the repository conftest
disabled:

    python -m pytest --noconftest -q -m cuda tests/test_torch_profiling_spans.py

There they show that the spans and the device trace's CUDA activity share one
clock, that a device span in a captured graph reads a captured sleep, in a
plain graph and in a conditional node's body, and that an untraced capture
holds no extra node.
"""
import ctypes
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch.geometry import se3
from easyhec_torch.models.calib import calibrate
from easyhec_torch.models.explorer import SpaceExplorer
from easyhec_torch.models.pose_init import global_search_init
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.robot import build_chain, load_link_meshes, make_box, make_cylinder, parse_urdf
from easyhec_torch.utils import profiling as P
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
TILE = TileConfig(16, 32, 128, binner="count", fused=True, compact_chunks=16, margin=2.0,
                  bin_big_k=64, bwd_band_only=True)
XI = np.array([0.02, -0.03, 1.2, 0.05, -0.08, 0.03], np.float32)


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.id)


def _newest(name):
    return max((s for s in P.spans() if s.name == name), key=lambda s: s.id)


def test_ring_keeps_the_newest_spans_up_to_its_bound():
    P.clear()
    for i in range(P.RING + 10):
        with P.span(f"s{i}"):
            pass
    got = P.spans()
    assert len(got) == P.RING
    assert got[0].name == "s10" and got[-1].name == f"s{P.RING + 9}"
    P.clear()
    assert P.spans() == []


def test_nesting_gives_parent_and_root_ids():
    P.clear()

    def other():
        with P.span("other"):
            pass

    with P.span("call"):
        with P.span("stage"):
            with P.span("inner"):
                pass
            # another thread keeps its own stack: a root there
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with P.span("stage"):
            pass
    with P.span("next call"):
        pass
    by = {s.name: s for s in P.spans()}
    call, inner = by["call"], by["inner"]
    stages = [s for s in P.spans() if s.name == "stage"]
    assert call.parent == 0 and call.root == call.id
    assert [s.parent for s in stages] == [call.id, call.id]
    assert inner.parent == stages[0].id and inner.root == call.id
    assert by["next call"].parent == 0 and by["next call"].root == by["next call"].id
    assert by["other"].parent == 0 and by["other"].root == by["other"].id
    for s in P.spans():
        assert s.start_ns <= s.end_ns
    assert call.start_ns <= stages[0].start_ns <= inner.start_ns <= inner.end_ns <= call.end_ns


def test_counts_are_recorded_at_the_close():
    P.clear()
    t0 = time.time_ns()
    with P.span("call", given=1) as counts:
        counts["rebins"] = 3
        counts["rebins"] += 2
    s = P.spans()[-1]
    assert s.counts == {"given": 1, "rebins": 5}
    counts["rebins"] = 99  # after the close: the recorded span keeps its own copy
    assert P.spans()[-1].counts["rebins"] == 5
    assert P.spans(since_ns=t0) == [s]
    assert P.spans(since_ns=time.time_ns() + 10**9) == []


def test_spans_appear_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("calib.call"):
            torch.ones(3).sum()
    assert "calib.call" in {e.name for e in prof.events()}


def test_device_spans_do_nothing_off_cuda():
    from torch.profiler import ProfilerActivity, profile

    P.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        d = P.DeviceSpans(("calib.rebin",), "cpu")
        with d.span("calib.rebin"):
            x = torch.ones(2) * 2
    assert d.rows is None and d.read() == {} and P.spans() == []
    assert x.tolist() == [2.0, 2.0]
    assert P.device_allocs("cpu") is None


def _calib_scene():
    meshes = [make_box((0.15, 0.15, 0.3)), make_cylinder(0.05, 0.4, sections=12)]
    r = RobotRenderer(meshes, H, W, tile=TILE, device="cpu")
    lp = np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1))
    lp[:, 1, 2, 3] = 0.3
    lp[1, 1, :3, 3] += np.float32([0.1, -0.05, 0.0])
    lp_t = torch.from_numpy(lp)
    with torch.no_grad():
        sil = r.silhouette(se3.exp(torch.from_numpy(XI)), lp_t, torch.from_numpy(K))
    return r, lp, (sil > 0.5).float().numpy()


def test_calibrate_records_its_call_and_chunks():
    r, lp, masks = _calib_scene()
    steps, chunk = 120, 50
    res = calibrate(XI + 0.02, r, lp, K, masks, num_steps=steps, rebin_every=0)
    sp = P.spans()
    call = _newest("calib.call")
    kids = [s.name for s in _children(sp, call)]
    n = -(-steps // chunk)
    assert kids == (["calib.prepare"] + ["calib.chunk.queue", "calib.chunk.read"] * n
                    + ["calib.finish"])
    assert call.counts == {"rebins": res.rebins, "kernel_steps": steps} and res.rebins > 0
    assert not [s for s in sp if s.name.startswith("graph.") and s.root == call.id]  # eager
    assert all(s.root == call.id for s in sp if s.start_ns >= call.start_ns)


def _rig():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf") as f:
        f.write(MINI_URDF)
        f.flush()
        model = parse_urdf(f.name)
    links = ["base", "upper", "fore"]
    meshes = load_link_meshes(model, link_names=links)
    return build_chain(model), [meshes[n] for n in links], links


def test_explore_records_its_call_and_counts():
    chain, meshes, links = _rig()
    r = RobotRenderer(meshes, H, W, tile=TILE, device="cpu")
    ex = SpaceExplorer(chain, r, links, n_sample_qposes=5, n_hypotheses=3, history_start=0,
                       score_batch=3)
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    gt = se3.log(torch.from_numpy(Tc)).numpy()
    history = (gt[None] + np.random.default_rng(0).normal(0, 0.05, (8, 6))).astype(np.float32)
    ex.explore(history, K, key=3)
    sp = P.spans()
    call = _newest("explore.call")
    score = ["explore.score.queue", "explore.score.read"]
    esc = ex.last_escalations
    assert [s.name for s in _children(sp, call)] == (
        ["explore.draw"] + score + (["explore.escalate"] + score) * esc + ["explore.finish"])
    assert call.counts == {"bin_states": ex.last_bin_states, "escalations": esc,
                           "shared": int(ex.last_shared)}
    assert ex.last_bin_states > 0 and esc == 1  # these small budgets overflow once


def test_global_search_records_its_stages():
    r, lp, masks = _calib_scene()
    global_search_init(r, lp, K, masks, radii=(1.2,), n_dirs=4, n_roll=2, downscale=4,
                       moment_iters=1, topk=2, refine_steps=2)
    sp = P.spans()
    call = _newest("search.call")
    assert [s.name for s in _children(sp, call)] == [
        "search.sweep", "search.moment_refine", "search.grad_refine"]


# ------------------------------------------------------------------ on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device spans and the device trace run on the card)")
    return torch.device("cuda")


def _sleep_cycles(ms: float) -> int:
    """Cycles of torch.cuda._sleep that take about ``ms``."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    torch.cuda.synchronize()
    return int(1_000_000 / a.elapsed_time(b) * ms)


def _eager_ms(n: int) -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reads = []
    for _ in range(3):
        a.record()
        torch.cuda._sleep(n)
        b.record()
        torch.cuda.synchronize()
        reads.append(a.elapsed_time(b))
    return float(np.median(reads))


@pytest.mark.cuda
def test_spans_and_the_device_trace_share_a_clock(card):
    from hec_bench import harness as hb

    n = _sleep_cycles(1.0)
    P.clear()
    with hb.Tracer() as t:
        for _ in range(3):  # the profiler's first launches and syncs are slow
            torch.cuda._sleep(n)
            torch.cuda.synchronize()
        t_meas = time.time_ns()
        for _ in range(5):
            with P.span("sleep"):
                torch.cuda._sleep(n)
                torch.cuda.synchronize()
    kernels = sorted(op for op in t.trace([]).ops if op[0] >= t_meas)
    spans = [s for s in P.spans() if s.name == "sleep"]
    assert len(kernels) == len(spans) == 5
    for (k0, k1, _), s in zip(kernels, spans):
        assert abs(k0 - s.start_ns) <= 100_000, (k0 - s.start_ns, s.end_ns - k1)
        assert abs(s.end_ns - k1) <= 100_000, (k0 - s.start_ns, s.end_ns - k1)


def _traced(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        return fn()


@pytest.mark.cuda
def test_a_device_span_reads_a_captured_sleep(card):
    from easyhec_torch.utils import cuda_graph as cg

    n = _sleep_cycles(1.0)
    x = torch.zeros(1, device=card)

    def fn():
        with d.span("sleep"):
            torch.cuda._sleep(n)
        x.add_(1)

    def capture():
        cg.warm_up(fn, cg.Counters([]), card)
        return cg.Graph(fn, cg.Counters([]))

    d = _traced(lambda: P.DeviceSpans(("sleep",), card))
    g = _traced(capture)
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    P.clear()
    got = d.read()["sleep"]
    want = 3 * _eager_ms(n)
    assert abs(got - want) <= 0.1 * want, (got, want)
    assert P.spans()[-1].counts["regions"] == 3
    assert d.read() == {}  # read, the totals start again


@pytest.mark.cuda
def test_a_device_span_times_a_conditional_body(card):
    from easyhec_torch.utils import cuda_graph as cg

    n = _sleep_cycles(1.0)
    flag = torch.ones((), dtype=torch.bool, device=card)
    x = torch.zeros(1, device=card)

    def body():
        with d.span("body"):
            torch.cuda._sleep(n)

    def tail():
        with d.span("tail"):
            x.add_(1)

    def capture():
        cg.warm_up(lambda: (body(), tail()), cg.Counters([]), card)
        return cg.CondGraph(flag, body, tail, cg.Counters([]))

    d = _traced(lambda: P.DeviceSpans(("body", "tail"), card))
    g = _traced(capture)
    for take in (True, False, True):
        flag.fill_(take)
        g.replay()
    torch.cuda.synchronize()
    P.clear()
    got = d.read()
    want = 2 * _eager_ms(n)
    assert abs(got["body"] - want) <= 0.1 * want, (got, want)
    regions = {s.name: s.counts["regions"] for s in P.spans()}
    assert regions == {"body": 2, "tail": 3}


@pytest.mark.cuda
def test_device_allocs_are_read_only_under_a_profiler(card):
    assert P.device_allocs(card) is None
    n = _traced(lambda: P.device_allocs(card))
    assert isinstance(n, int) and n >= 0


def _node_types(graph) -> list[int]:
    """The node types of a keep_graph capture (libcuda's cuGraphGetNodes and
    cuGraphNodeGetType; 0 is a kernel node)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    out = []
    for node in nodes:
        t = ctypes.c_int()
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        out.append(t.value)
    return out


@pytest.mark.cuda
def test_an_untraced_capture_holds_no_extra_node(card):
    from easyhec_torch.utils import cuda_graph as cg

    x = torch.zeros(1, device=card)

    def fn(d):
        with d.span("sleep") if d is not None else torch.no_grad():
            torch.cuda._sleep(1000)
        x.add_(1)

    def types(d):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        cg.warm_up(lambda: fn(d), cg.Counters([]), card)
        with torch.cuda.graph(g):
            fn(d)
        return _node_types(g)

    plain = types(None)
    assert plain == [0, 0]
    assert types(P.DeviceSpans(("sleep",), card)) == plain
    traced = _traced(lambda: types(P.DeviceSpans(("sleep",), card)))
    assert traced == [0] * 4  # the two clock kernels
