"""One run of one benchmark cell of easyhec_torch on NVIDIA GPUs.

    python hec_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds the kernels (first run only),
makes the cell's inputs from the seed, builds the program's objects and
makes one warm call; then the window: calls back to back until --seconds
have passed (--trace 0), or one call under a trace of CUDA activity
(--trace 1). After it: the peak memory, the per-layer readers (traced
runs), the reference check. The last line of standard output is the
result; the numbers compared, each with its limit, are the last lines of
standard error. Exits 2 without a result where CUDA or the cell's cards
are missing, 3 where JAX or easyhec_tpu was loaded by the time the result
would be printed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hec_bench import harness as hb  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    hb.env_defaults()
    man = hb.manifest()
    wl = hb.cell(a.workload)
    cfg = hb.config(wl["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"hec_bench: the cell needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return run(a, man, wl, cfg, "cuda")


def run(a, man, wl, cfg, device) -> int:
    """The run proper, on ``device`` (a test drives it on the CPU)."""
    import torch

    mod = hb.traffic(wl["traffic"])
    tr = mod.setup(cfg, wl, a.seed, device)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    records, spans, failed, secs = [], [], 0, []
    tracer = hb.Tracer() if a.trace and cuda else None
    if tracer is not None:
        tracer.__enter__()
    t0 = time.perf_counter()
    t_end = t0
    while True:
        s_ns = time.time_ns()
        try:
            rec = tr.call(len(records))
            sync()
        except Exception as e:  # a call that fails is counted, and the run is not correct
            print(f"hec_bench: call {len(records)} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            rec = None
        secs.append(time.perf_counter() - t_end)
        t_end = time.perf_counter()
        spans.append((s_ns, time.time_ns(), f"{wl['traffic']} call {len(records)}"))
        records.append(rec)
        if a.trace or t_end - t0 >= a.seconds:
            break
    trace = None
    if tracer is not None:
        tracer.__exit__(None, None, None)
        trace = tracer.trace(spans)
    window_s = t_end - t0
    done = [r for r in records if r is not None]
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": wl["chips"],
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    metrics, breakdown = {}, None
    if a.trace:
        ctx = hb.Ctx(tr, done, trace)
        for m in hb.metrics_for(man, wl["name"], "per_layer"):
            value = hb.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace is not None:
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.window_s
            breakdown = trace.breakdown()
    else:
        per_call = window_s / max(len(done), 1)
        for m in hb.metrics_for(man, wl["name"], "end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == wl["metric"]:
                metrics[m["name"]] = {"value": per_call, "unit": m["unit"]}
    print(f"hec_bench: {wl['name']} seed {a.seed}: {len(records)} calls in {window_s:.3f} s, "
          f"{failed} failed; setup {setup_s:.3f} s; {hb.gpu_line() if cuda else 'cpu'}; "
          f"seconds a call: {[round(x, 4) for x in secs]}", file=sys.stderr)
    tr.release()
    ok, checks = tr.check(done, a.seed)
    correct = ok and failed == 0 and len(done) > 0
    hb.print_checks(checks)
    found = hb.jax_loaded()  # after the window, the readers and the check
    if found:
        print(f"hec_bench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(hb.result_line(correct, len(records), failed, metrics, dev, checks, breakdown))
    return 0


if __name__ == "__main__":
    sys.exit(main())
