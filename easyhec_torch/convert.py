"""Carry calibration state and renderer arrays between easyhec_tpu and
easyhec_torch.

Both packages' ``calibrate(step_hook=...)`` emit, after every chunk of
steps, a resumable dict of host arrays: ``dof``, ``step``, ``losses``,
``history`` and the optimizer state as ``opt_0..opt_N`` in optax leaf order
(Adam: count, mu, nu, schedule count; SGD: trace, schedule count). The port
keeps optax's leaves (solver/optim.py), so converting is a matter of
checking the leaves and normalizing dtypes and shapes — after which a run
interrupted in either package resumes in the other.

This module imports neither JAX nor easyhec_tpu; the JAX side is handed in
as plain dicts and as a renderer object whose arrays numpy can read.
"""
from __future__ import annotations

import numpy as np

from .robot.mesh import TriMesh

__all__ = [
    "state_from_jax",
    "state_to_jax",
    "renderer_static_arrays",
    "check_renderer_static",
]

# optax leaf layouts: (dtype, shape-like) per opt_i leaf; "p" = dof-shaped
_LEAVES = {
    "adam": (("int32", ()), ("float32", "p"), ("float32", "p"), ("int32", ())),
    "sgd": (("float32", "p"), ("int32", ())),
}


def _normalize(state: dict, optimizer: str) -> dict:
    layout = _LEAVES.get(optimizer.lower())
    if layout is None:
        raise ValueError(f"no leaf layout for optimizer {optimizer!r}")
    n_opt = sum(1 for k in state if k.startswith("opt_"))
    if n_opt != len(layout):
        raise ValueError(
            f"{optimizer} state has {len(layout)} optimizer leaves, got {n_opt}"
        )
    dof = np.asarray(state["dof"], np.float32).reshape(6)
    out = {"dof": dof, "step": int(state["step"])}
    for i, (dtype, shape) in enumerate(layout):
        leaf = np.asarray(state[f"opt_{i}"]).astype(dtype)
        want = dof.shape if shape == "p" else shape
        if leaf.shape != want:
            raise ValueError(f"opt_{i}: shape {leaf.shape}, expected {want}")
        out[f"opt_{i}"] = leaf
    out["losses"] = np.asarray(state.get("losses", np.zeros(0)), np.float32).reshape(-1)
    out["history"] = np.asarray(
        state.get("history", np.zeros((0, 6))), np.float32
    ).reshape(-1, 6)
    if out["step"] and len(out["losses"]) != out["step"]:
        raise ValueError(
            f"losses hold {len(out['losses'])} steps, state says {out['step']}"
        )
    return out


def state_from_jax(state: dict, optimizer: str = "adam") -> dict:
    """An easyhec_tpu step_hook / resume_state dict -> an easyhec_torch
    resume_state (dof plus opt_0..opt_N in optax leaf order)."""
    return _normalize(state, optimizer)


def state_to_jax(state: dict, optimizer: str = "adam") -> dict:
    """An easyhec_torch step_hook dict -> an easyhec_tpu resume_state."""
    return _normalize(state, optimizer)


def renderer_static_arrays(link_meshes: list[TriMesh]) -> dict[str, np.ndarray]:
    """The renderer's static arrays, built from numpy meshes exactly as both
    packages' RobotRenderer builds them: corners_rest [3, 4, F],
    face_link_onehot [L, F], link_aabb_corners [L, 8, 3]."""
    from .render.renderer import RobotRenderer

    r = RobotRenderer(link_meshes, 1, 1, device="cpu")
    return {
        "corners_rest": r.corners_rest.numpy(),
        "face_link_onehot": r.face_link_onehot.numpy(),
        "link_aabb_corners": r.link_aabb_corners(),
    }


def check_renderer_static(torch_renderer, jax_renderer) -> None:
    """Raise unless the two renderers hold equal static arrays."""
    pairs = {
        "corners_rest": (torch_renderer.corners_rest.cpu().numpy(),
                         np.asarray(jax_renderer.corners_rest)),
        "face_link_onehot": (torch_renderer.face_link_onehot.cpu().numpy(),
                             np.asarray(jax_renderer.face_link_onehot)),
        "link_aabb_corners": (torch_renderer.link_aabb_corners(),
                              np.asarray(jax_renderer.link_aabb_corners())),
    }
    for name, (a, b) in pairs.items():
        if a.shape != b.shape or not np.array_equal(a, b):
            raise ValueError(f"renderer static array {name} differs between packages")
    if (torch_renderer.H, torch_renderer.W) != (jax_renderer.H, jax_renderer.W):
        raise ValueError("renderer image sizes differ between packages")
