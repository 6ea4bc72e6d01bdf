"""The program's own spans (easyhec_torch.utils.profiling) inside a traced
window, and the device's idle time put down to them.

The program records a span at each of its layer boundaries, on the host's
``time.time_ns()`` clock, the clock of the trace's device timestamps. Each
idle gap of the window (between the union's busy intervals, and at its two
ends) goes whole to the innermost host span that holds the gap's midpoint,
or to no span. A checkout whose program records no spans gives None here,
and every reader of a span metric then returns None.
"""
from __future__ import annotations

import bisect


def in_window(trace) -> list | None:
    """The program's spans that start and end inside the trace's window;
    None without a trace or where the program has no span recorder."""
    if trace is None:
        return None
    try:
        from easyhec_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return [s for s in read(since_ns=trace.t0) if s.end_ns <= trace.t1]


def named(spans, name: str) -> list:
    return [s for s in spans or () if s.name == name]


def subtree(spans, tops) -> list:
    """The spans of ``tops`` and every span below them."""
    ids = {t.id for t in tops}
    out = []
    for s in sorted(spans, key=lambda s: s.id):  # a parent opens before its children
        if s.id in ids or s.parent in ids:
            ids.add(s.id)
            out.append(s)
    return out


def idle_gaps(trace) -> list[tuple[int, int]]:
    """The window's idle intervals in ns: before, between and after the
    union of the device ops' intervals."""
    gaps, prev = [], trace.t0
    for s, e in trace.busy_intervals() + [(trace.t1, trace.t1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def idle_by_span(trace, spans) -> tuple[dict[int, int], int]:
    """Each idle gap put down whole to the innermost host span (the latest
    started) that holds its midpoint: ({span id: idle ns}, idle ns that no
    span holds). The two parts sum to the window's idle time."""
    host = [s for s in spans if s.end_ns > s.start_ns]
    cuts = sorted({t for s in host for t in (s.start_ns, s.end_ns)})
    owner = []  # the innermost span over [cuts[i], cuts[i + 1])
    for a in cuts[:-1]:
        inner = None
        for s in host:
            if s.start_ns <= a < s.end_ns and (
                    inner is None or (s.start_ns, s.id) > (inner.start_ns, inner.id)):
                inner = s
        owner.append(inner)
    by, outside = {}, 0
    for a, b in idle_gaps(trace):
        i = bisect.bisect_right(cuts, (a + b) // 2) - 1
        s = owner[i] if 0 <= i < len(owner) else None
        if s is None:
            outside += b - a
        else:
            by[s.id] = by.get(s.id, 0) + b - a
    return by, outside


def idle_split(ctx, call: str, queue: str, read: str):
    """Device-idle ms per ``call`` span of the window, split in two:
    (in flight, host). In flight: the gaps wholly inside one chunk of
    replays, from a ``queue`` span's start to the end of the ``read`` span
    that follows it, while the device works through the chunk the host
    queued or is still queueing (the host blocks in the graph launches once
    the launch queue is full). Host: the rest of the idle put down to the
    call's spans (the capture, the preparation, the chunk boundaries, the
    copies out). None without the call's spans."""
    sp = in_window(ctx.trace)
    calls = named(sp, call)
    if not calls:
        return None
    below = subtree(sp, calls)
    by, _ = idle_by_span(ctx.trace, sp)
    starts = sorted(s.start_ns for s in below if s.name == queue)
    ends = sorted(s.end_ns for s in below if s.name == read)
    flight = 0
    for a, b in idle_gaps(ctx.trace):
        i = bisect.bisect_right(starts, a) - 1
        if 0 <= i < len(ends) and b <= ends[i]:
            flight += b - a
    host = sum(by.get(s.id, 0) for s in below) - flight
    return flight / 1e6 / len(calls), host / 1e6 / len(calls)


def capture_ms(ctx, call: str) -> float | None:
    """Host ms per ``call`` span of the window in the graph.* spans below
    it (warm-ups, captures, instantiations), nested ones counted once."""
    sp = in_window(ctx.trace)
    calls = named(sp, call)
    if not calls:
        return None
    below = subtree(sp, calls)
    graph = {s.id for s in below if s.name.startswith("graph.")}
    ns = sum(s.end_ns - s.start_ns for s in below if s.id in graph and s.parent not in graph)
    return ns / 1e6 / len(calls)


def device_ms_per_region(ctx, call: str, name: str) -> float | None:
    """Device ms of the ``name`` device spans below the window's ``call``
    spans, per timed region (one run of the region in a replay)."""
    sp = in_window(ctx.trace)
    calls = named(sp, call)
    if not calls:
        return None
    dev = [s for s in subtree(sp, calls) if s.name == name and "device_ms" in s.counts]
    regions = sum(s.counts["regions"] for s in dev)
    if not regions:
        return None
    return sum(s.counts["device_ms"] for s in dev) / regions


def count(ctx, call: str, key: str) -> float | None:
    """The mean of the ``key`` count over the window's ``call`` spans."""
    vals = [s.counts[key] for s in named(in_window(ctx.trace), call) if key in s.counts]
    return sum(vals) / len(vals) if vals else None
