"""The benchmark's machinery: the manifest, cells, configurations, traffic
modules and per-layer readers found by name; the measured window; the
device trace; the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic kind; ``traffic/<kind>.py``
drives it through ``setup(cfg, cell, seed, device) -> Traffic``, whose
``call(i)`` is one timed call and whose ``check(records)`` decides
``correct``; each per-layer metric that BENCHMARK.json lists for the cell is
read by ``metrics/<name>.py::read(ctx)``. Adding any of them is adding a
file and a manifest entry.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "easyhec_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    path = HERE / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"hec_bench: no cell {name!r} ({path.relative_to(ROOT)} is missing)")
    wl = load_json(path)
    wl["name"] = name
    return wl


def config(name: str) -> dict:
    cfg = load_json(HERE / "configs" / f"{name}.json")
    cfg["name"] = name
    return cfg


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    return _module(HERE / "traffic" / f"{kind}.py", f"hec_bench.traffic.{kind}")


def reader(metric: str):
    return _module(HERE / "metrics" / f"{metric}.py", f"hec_bench.metrics.{metric}")


def metrics_for(man: dict, wl_name: str, section: str) -> list[dict]:
    """The manifest's metrics of ``section`` that this cell reports: those
    that list it under ``workloads``, and end-to-end metrics without the
    key (``setup_s``), which every cell reports."""
    return [m for m in man[section]
            if wl_name in m.get("workloads", ()) or (section == "end_to_end" and "workloads" not in m)]


def jax_loaded() -> list[str]:
    """Modules whose top-level name (before the first dot) is JAX's, flax's
    or the JAX package's, compared whole."""
    return sorted({k for k in sys.modules if k.split(".")[0] in JAX_NAMES})


# ------------------------------------------------------------------ timing


def device_ms(fn, reps: int, warm: int = 2) -> float:
    """Device busy milliseconds per call of fn over reps calls: the union of
    the device ops' intervals in a trace of CUDA activity only, whatever
    pace the host sets (chip_smoke.py:215-231's _busy_ms, over intervals).
    CUDA events around queued calls (chip_smoke.py:247's _time_ms) read the
    host's pace here: the port's entries enqueue more kernels a call than
    the launch queue holds ahead of the card."""
    for _ in range(warm):
        fn()
    with Tracer() as t:
        for _ in range(reps):
            fn()
    return t.trace([]).busy_s * 1e3 / reps


def gpu_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no card listed"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


# ------------------------------------------------------------------ trace


@dataclass
class Trace:
    """Device activity of a traced window (CUDA activity only: kernels,
    copies, sets), in host epoch ns, with the host's own spans."""

    t0: int
    t1: int
    ops: list = field(default_factory=list)  # (start_ns, end_ns, name)
    spans: list = field(default_factory=list)  # (start_ns, end_ns, label)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device ops' intervals, clipped to the window."""
        out = []
        for s, e, _ in sorted(self.ops):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_share(self) -> float:
        """Per cent of the window with no device op running (the busy-share
        arithmetic of chip_smoke.py:215-231, over the union of intervals)."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, n: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps
        labelled by the host span they fall in."""
        by = {}
        for s, e, name in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)

        def label(a, b):
            mid = (a + b) // 2
            for s, e, lab in self.spans:
                if s <= mid < e:
                    return lab
            return "harness between calls"

        top = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[label(a, b), (b - a) / 1e9] for a, b in top]}


class Tracer:
    """torch.profiler over CUDA activity only, read into a Trace."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def trace(self, spans) -> Trace:
        from torch.autograd import DeviceType

        ops = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CPU or ev.is_user_annotation():
                continue
            s = ev.start_ns()
            ops.append((s, s + ev.duration_ns(), ev.name()))
        return Trace(self.t0, self.t1, ops, list(spans))


# ------------------------------------------------------------------ result


@dataclass
class Ctx:
    """What a per-layer reader gets: the traffic object (its program
    objects and inputs), the window's call records, the trace of a traced
    run, and the timing helper."""

    traffic: object
    records: list
    trace: Trace | None
    device_ms: object = device_ms


def print_checks(checks: list) -> None:
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)


def env_defaults() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a library."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / "cache" / "triton"))
