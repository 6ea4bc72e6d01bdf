"""The readers of the program's spans (hec_bench/spans.py and the metrics
that use it), on the CPU: the idle attribution on a synthetic trace and span
list, the readers on spans the recorder took, and None from every reader
where the spans are absent (a checkout whose program records none)."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from easyhec_torch.utils import profiling
from easyhec_torch.utils.profiling import Span
from hec_bench import harness as hb
from hec_bench import spans as ps

READERS = ["capture_ms.calib", "idle_graph_ms.calib", "idle_host_ms.calib", "rebin_ms.calib",
           "device_allocs.calib", "capture_ms.explore", "rebin_ms.explore",
           "render_ms.explore"]


def _span(i, parent, name, a, b, **counts):
    return Span(i, parent, 1, name, a, b, counts)


# window 0..1100 ns; device busy 100-200, 300-400, 700-900
TRACE = hb.Trace(0, 1100, [(100, 200, "k"), (300, 400, "k"), (700, 900, "k")])
SPANS = [
    _span(1, 0, "calib.call", 10, 990),
    _span(2, 1, "graph.capture", 10, 120),  # starts with the call: the inner one wins
    _span(3, 1, "calib.chunk.queue", 150, 450),
    _span(4, 1, "calib.chunk.read", 450, 960),
    _span(5, 4, "calib.rebin", 600, 600, device_ms=2.0, regions=1),
]


def test_idle_goes_to_the_innermost_span_at_its_midpoint():
    assert ps.idle_gaps(TRACE) == [(0, 100), (200, 300), (400, 700), (900, 1100)]
    by, outside = ps.idle_by_span(TRACE, SPANS)
    assert by == {2: 100, 3: 100, 4: 300}
    assert outside == 200  # the last gap's midpoint, 1000, is after the call
    idle = 1100 - 400
    assert sum(by.values()) + outside == idle


def test_idle_split_in_flight_and_host_sum_to_the_window_idle(monkeypatch):
    monkeypatch.setattr(ps, "in_window", lambda trace: SPANS)
    flight, host = ps.idle_split(SimpleNamespace(trace=TRACE), "calib.call",
                                 "calib.chunk.queue", "calib.chunk.read")
    # in flight: the gaps wholly inside 150-960; host: the capture's gap
    assert (flight, host) == (400 / 1e6, 100 / 1e6)
    _, outside = ps.idle_by_span(TRACE, SPANS)
    assert (flight + host) * 1e6 + outside == pytest.approx(TRACE.idle_share() / 100 * 1100)


def test_readers_read_the_recorders_spans():
    profiling.clear()
    t0 = time.time_ns()
    with profiling.span("calib.call") as counts:
        with profiling.span("graph.warm_up"):
            time.sleep(0.002)
        with profiling.span("graph.capture"):
            time.sleep(0.003)
        with profiling.span("calib.chunk.queue"):
            q = time.time_ns()
        with profiling.span("calib.chunk.read"):
            time.sleep(0.004)
            profiling._record("calib.rebin", {"device_ms": 6.0, "regions": 3})
        counts["device_allocs"] = 65
    t1 = time.time_ns()
    # two ops inside the chunk: the 1 ms between them is in flight, the rest host
    ms = 1_000_000
    ops = [(q + ms, q + 3 * ms // 2, "k"), (q + 5 * ms // 2, q + 3 * ms, "k")]
    trace = hb.Trace(t0, t1, ops)
    ctx = hb.Ctx(None, [], trace)
    graph = [s for s in profiling.spans() if s.name.startswith("graph.")]
    assert hb.reader("capture_ms.calib").read(ctx) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in graph) / 1e6)
    assert hb.reader("capture_ms.calib").read(ctx) >= 5.0
    assert hb.reader("rebin_ms.calib").read(ctx) == 2.0
    assert hb.reader("device_allocs.calib").read(ctx) == 65
    flight = hb.reader("idle_graph_ms.calib").read(ctx)
    host = hb.reader("idle_host_ms.calib").read(ctx)
    assert flight == pytest.approx(1.0) and host >= 5.0
    assert flight + host == pytest.approx((trace.window_s - trace.busy_s) * 1e3, abs=1e-6)
    for name in ("capture_ms.explore", "rebin_ms.explore", "render_ms.explore"):
        assert hb.reader(name).read(ctx) is None  # no explore.call in the window


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_without_its_spans(name, monkeypatch):
    profiling.clear()
    t0 = time.time_ns()
    trace = hb.Trace(t0, t0 + 10**6, [(t0 + 10, t0 + 20, "k")])
    read = hb.reader(name).read
    assert read(hb.Ctx(None, [], None)) is None
    assert read(hb.Ctx(None, [], trace)) is None  # nothing recorded in the window
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert read(hb.Ctx(None, [], trace)) is None
