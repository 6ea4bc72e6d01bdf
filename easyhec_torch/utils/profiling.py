"""Tracing and wall-clock probes.

Counterpart of easyhec_tpu/utils/profiling.py, with the port's span
recorder:

- `span(name, **counts)`: a host span, ``with span("calib.call") as c:
  ...; c["rebins"] = n``, recorded at its close as a `Span` (its id, its
  parent's id, the id of the root span of the public call it belongs to,
  name, start and end from ``time.time_ns()``, counts) in a ring of the
  last `RING` spans. Parents come from a stack per thread. Always on; a
  span costs a few microseconds. While a torch profiler records, each span
  also opens a ``torch.profiler.record_function`` of its name, so a
  profiler trace (`trace`) shows it beside the kernels. `spans()` reads
  the ring and `clear()` empties it.
- `DeviceSpans`: device time of named regions of a CUDA graph, summed over
  its replays by a device clock captured around each region, only where a
  torch profiler records the call; ``read()`` stores the totals as spans,
  after a host read the caller makes anyway.
- `device_allocs(device)`: the caching allocator's count of cudaMalloc
  calls so far (``num_device_alloc``) while a torch profiler records, None
  off CUDA or untraced.
- `trace(logdir)`: a torch.profiler trace (host and CUDA activity) around
  any region, written into ``logdir`` as a Chrome trace
  (``trace.json``; open it in Perfetto or chrome://tracing).
- `EvalTimer`: named wall-clock probes that synchronize the device of a
  CUDA tensor first, so a probe times the device's work and not its
  enqueue.
- `raster_roofline(...)`: the analytic FLOPs/bytes/arithmetic-intensity
  estimate for one silhouette forward pass, against an NVIDIA H100's peaks
  by default.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["trace", "EvalTimer", "raster_roofline", "TRACE_NAME", "Span", "span", "spans",
           "clear", "DeviceSpans", "device_allocs", "RING"]

TRACE_NAME = "trace.json"
RING = 8192  # spans kept: the newest, oldest dropped first


class Span(NamedTuple):
    """One recorded span. ``parent`` is 0 at a root; ``root`` is the id of
    the outermost span open when it started (its own id at a root). A
    device span (`DeviceSpans.read`) starts and ends at its host read and
    carries ``device_ms`` and ``regions`` in ``counts``."""

    id: int
    parent: int
    root: int
    name: str
    start_ns: int
    end_ns: int
    counts: dict


_ring: deque = deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()


def _open() -> list:
    """This thread's stack of open spans."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class span:
    """``with span(name, **counts) as counts: ...``: records a `Span` at
    the block's close, with ``counts`` as the block left them (set a count
    at the boundary where it is known: ``counts["rebins"] = n``)."""

    __slots__ = ("name", "counts", "id", "parent", "root", "start_ns", "fn")

    def __init__(self, name: str, **counts):
        self.name, self.counts = name, counts

    def __enter__(self) -> dict:
        stack = _open()
        self.id = next(_ids)
        self.parent, self.root = (stack[-1].id, stack[-1].root) if stack else (0, self.id)
        stack.append(self)
        self.fn = None
        if _profiling():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.start_ns = time.time_ns()
        return self.counts

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _open().pop()
        _ring.append(Span(self.id, self.parent, self.root, self.name, self.start_ns, end,
                          dict(self.counts)))
        return False


def spans(since_ns: int | None = None) -> list[Span]:
    """The recorded spans in the order they closed; with ``since_ns``, only
    those that started at or after it."""
    out = list(_ring)
    return out if since_ns is None else [s for s in out if s.start_ns >= since_ns]


def clear() -> None:
    """Empty the ring."""
    _ring.clear()


def _record(name: str, counts: dict) -> None:
    """A span of no host duration under the innermost open span."""
    stack = _open()
    i, now = next(_ids), time.time_ns()
    parent, root = (stack[-1].id, stack[-1].root) if stack else (0, i)
    _ring.append(Span(i, parent, root, name, now, now, counts))


class DeviceSpans:
    """Device time of named regions of the CUDA graphs a call captures:
    ``with d.span(name): ...`` inside a capture puts two one-thread kernels
    around the region (ops/csrc/device_clock.cu): the first reads the
    device's global nanosecond timer, the second adds the time since to the
    name's total and counts the close, at every replay. Only where a torch
    profiler records when the object is made (on CUDA) and the region is
    being captured: elsewhere ``span`` does nothing, so an untraced graph
    holds no extra node. ``read()``, called after a host read that waited
    for the replays, records each name closed since the last read as a span
    (`_record`) with ``device_ms`` (the total) and ``regions`` (the closes),
    starts the totals again, and returns {name: device_ms}. (CUDA events
    would do outside a conditional node; its body may hold none.)"""

    def __init__(self, names, device):
        self.names = tuple(names)
        self.rows = None
        if _profiling() and torch.device(device).type == "cuda":
            self.rows = torch.zeros((len(self.names), 3), dtype=torch.int64, device=device)

    def span(self, name: str):
        if self.rows is None or not torch.cuda.is_current_stream_capturing():
            return contextlib.nullcontext()
        return self._stamped(self.rows[self.names.index(name)])

    @staticmethod
    @contextlib.contextmanager
    def _stamped(row):
        _stamp(row, False)
        yield
        _stamp(row, True)

    def read(self) -> dict[str, float]:
        if self.rows is None:
            return {}
        rows = self.rows.tolist()
        self.rows.zero_()
        out = {}
        for name, (_, total_ns, closes) in zip(self.names, rows):
            if closes:
                out[name] = total_ns / 1e6
                _record(name, {"device_ms": out[name], "regions": closes})
        return out


def _stamp(row: torch.Tensor, close: bool) -> None:
    """Launch device_clock.cu's open or close kernel on ``row`` on the
    current stream (captured into the graph being built)."""
    from ..ops import _build

    lib = _build.load("device_clock")
    if not getattr(lib, "typed", False):
        lib.device_clock_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.device_clock_stamp.restype = ctypes.c_int
        lib.device_clock_error_string.argtypes = [ctypes.c_int]
        lib.device_clock_error_string.restype = ctypes.c_char_p
        lib.typed = True
    rc = lib.device_clock_stamp(row.data_ptr(), int(close),
                                torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"device_clock_stamp: CUDA error {rc} "
                           f"({lib.device_clock_error_string(rc).decode()})")


def device_allocs(device) -> int | None:
    """cudaMalloc calls the caching allocator has made on ``device`` so far
    (``num_device_alloc``), while a torch profiler records; None off CUDA or
    with no profiler, so an untraced call pays nothing (a read of the
    allocator's statistics takes ~0.15 ms on the card's host)."""
    device = torch.device(device)
    if device.type != "cuda" or not _profiling():
        return None
    return torch.cuda.memory_stats(device).get("num_device_alloc")


@contextlib.contextmanager
def trace(logdir, enabled: bool = True):
    """Profile a region: ``with trace(out / "trace"): step()`` writes
    ``out/trace/trace.json``. CUDA activity is recorded when a GPU is
    present."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / TRACE_NAME))


@dataclass
class EvalTimer:
    """Named wall-clock probes (the reference's EvalTime, cfg.evaltime).

    >>> t = EvalTimer(enabled=True)
    >>> t("start"); work(); t("render", sync=out)   # time since previous mark
    """

    enabled: bool = True
    marks: dict[str, list[float]] = field(default_factory=dict)
    _last: float | None = None

    def __call__(self, name: str, sync=None) -> None:
        if not self.enabled:
            return
        if torch.is_tensor(sync) and sync.is_cuda:  # wait for the device's work
            torch.cuda.synchronize(sync.device)
        now = time.perf_counter()
        if self._last is not None:
            self.marks.setdefault(name, []).append(now - self._last)
        self._last = now

    def summary(self) -> dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.marks.items() if v}


def raster_roofline(
    n_pixels: int,
    n_triangles: int,
    capacity: int,
    flops_per_pix_tri: float = 24.0,
    bytes_per_pixel: float = 8.0,
    peak_flops: float = 67e12,
    peak_bw: float = 3.35e12,
) -> dict[str, float]:
    """Estimate the speed-of-light for one silhouette forward pass.

    The tiled kernel evaluates `capacity` candidate triangles per pixel
    (edge functions + soft coverage ≈ flops_per_pix_tri each) and writes the
    coverage image once. The default peaks are an NVIDIA H100 80GB HBM3's
    at its 700 W limit (data sheet): 67 TFLOP/s FP32 outside the tensor
    cores and 3.35 TB/s of HBM. Returns arithmetic intensity and the
    compute/memory bound in pixels/s.
    """
    flops = n_pixels * capacity * flops_per_pix_tri
    bytes_moved = n_pixels * bytes_per_pixel + n_triangles * 64.0
    ai = flops / bytes_moved
    t_compute = flops / peak_flops
    t_memory = bytes_moved / peak_bw
    bound = max(t_compute, t_memory)
    return {
        "flops": flops,
        "bytes": bytes_moved,
        "arith_intensity": ai,
        "compute_bound_pix_s": n_pixels / t_compute,
        "memory_bound_pix_s": n_pixels / t_memory,
        "speed_of_light_pix_s": n_pixels / bound,
    }
