"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled at first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

into ``easyhec_torch/ops/build/`` (listed in .gitignore; override with
``EASYHEC_TORCH_BUILD_DIR``), then loaded with ctypes. The file name carries
a hash of the source and of the shared headers ``csrc/*.cuh``, so an edited
kernel is rebuilt and a stale library is never loaded. ``build_all`` starts one nvcc per source, all at once.
Nothing is fetched: the CUDA toolkit's nvcc and headers are all it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["sources", "build_all", "load", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    d = os.environ.get("EASYHEC_TORCH_BUILD_DIR")
    return Path(d) if d else Path(__file__).resolve().parent / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "compiled from easyhec_torch/ops/csrc at first use"
    )


def sources() -> list[str]:
    """Kernel source names (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    # The hash covers every header of csrc too: the sources share device
    # code through csrc/*.cuh, and an edited header must rebuild them all.
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every missing kernel library, one nvcc per source, started
    together. Returns {name: seconds} for the sources built now; raises
    with nvcc's output if any build fails."""
    names = sources() if names is None else names
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    _build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _target(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    secs, failed = {}, []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        _target(n).with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc rc {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
