"""Port parity of the public surface: every public name of each easyhec_tpu
module has its counterpart in the same easyhec_torch module.

A module's public names are its ``__all__``, every name a package
``__init__`` binds, and the public functions and classes the module defines
itself. The port must bind each, list JAX's ``__all__`` in its own, and for
each public function, each class's constructor and each public method a
class defines, take JAX's parameter names (it may take more). One case per
JAX module.

The allowlist holds the logged divergences, each on its ROADMAP.md §3 line.
"""
import importlib
import inspect
from pathlib import Path

import pytest

from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "easyhec_tpu"
MODULES = sorted(
    ".".join(("easyhec_tpu",) + p.relative_to(JAX_PKG).with_suffix("").parts[:-1])
    if p.name == "__init__.py"
    else ".".join(("easyhec_tpu",) + p.relative_to(JAX_PKG).with_suffix("").parts)
    for p in JAX_PKG.rglob("*.py")
)

# (port module, name) -> JAX parameters the port does not take
ALLOWED = {
    # ROADMAP §3 "Draws": the port draws from a torch.Generator, not a key
    ("easyhec_torch.data", "sample_qposes"): {"key"},
    ("easyhec_torch.data.synthetic", "sample_qposes"): {"key"},
    # ROADMAP §3 "flax's UNet.parent/name": flax.linen.Module's own fields
    ("easyhec_torch.models.segmentation", "UNet"): {"parent", "name"},
}


def _public(mod) -> set[str]:
    names = set(getattr(mod, "__all__", ()))
    is_pkg = hasattr(mod, "__path__")
    for k, v in vars(mod).items():
        if k.startswith("_"):
            continue
        if is_pkg and not inspect.ismodule(v):
            names.add(k)
        if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == mod.__name__:
            names.add(k)
    return names


def _params(f) -> list[str] | None:
    try:
        return list(inspect.signature(f).parameters)
    except (TypeError, ValueError):  # a builtin without a signature
        return None


def _missing_params(j, t, key) -> list[str]:
    pj, pt = _params(j), _params(t)
    if pj is None or pt is None:
        return []
    return [p for p in pj if p not in pt and p not in ALLOWED.get(key, ())]


def test_module_list_covers_the_package():
    assert len(MODULES) >= 60 and "easyhec_tpu.geometry" in MODULES
    assert "easyhec_tpu.ops.pose_raster" in MODULES


@pytest.mark.parametrize("jname", MODULES)
def test_public_surface_matches_jax(jname):
    jm = importlib.import_module(jname)
    tname = "easyhec_torch" + jname[len("easyhec_tpu"):]
    tm = importlib.import_module(tname)
    faults = []
    if hasattr(jm, "__all__") and hasattr(tm, "__all__"):
        faults += [f"__all__ lacks {n}" for n in jm.__all__ if n not in tm.__all__]
    elif hasattr(jm, "__all__") and hasattr(tm, "__path__"):
        faults.append("package has no __all__")
    for n in sorted(_public(jm)):
        if not hasattr(tm, n):
            faults.append(f"no {n}")
            continue
        jv, tv = getattr(jm, n), getattr(tm, n)
        if not (inspect.isfunction(jv) or inspect.isclass(jv)):
            continue
        miss = _missing_params(jv, tv, (tname, n))
        if miss:
            faults.append(f"{n} lacks parameters {miss}")
        if not inspect.isclass(jv):
            continue
        for k, v in vars(jv).items():
            if k.startswith("_") or not (inspect.isfunction(v) or isinstance(
                    v, (property, staticmethod, classmethod))):
                continue
            if not hasattr(tv, k):
                faults.append(f"no {n}.{k}")
            elif inspect.isfunction(v):
                miss = _missing_params(v, getattr(tv, k), (tname, f"{n}.{k}"))
                if miss:
                    faults.append(f"{n}.{k} lacks parameters {miss}")
    assert not faults, f"{tname}: " + "; ".join(faults)


def test_allowlist_is_live():
    """Each allowlisted divergence still exists (a closed one leaves the list)."""
    for (tname, n), params in ALLOWED.items():
        jm = importlib.import_module("easyhec_tpu" + tname[len("easyhec_torch"):])
        tm = importlib.import_module(tname)
        assert set(params) <= set(_params(getattr(jm, n)))
        assert not set(params) & set(_params(getattr(tm, n)))
