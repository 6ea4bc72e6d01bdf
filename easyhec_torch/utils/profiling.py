"""Tracing and wall-clock probes.

Counterpart of easyhec_tpu/utils/profiling.py:

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
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

__all__ = ["trace", "EvalTimer", "raster_roofline", "TRACE_NAME"]

TRACE_NAME = "trace.json"


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
