"""Carry calibration state, renderer arrays and segmenter weights between
easyhec_tpu and easyhec_torch.

Both packages' ``calibrate(step_hook=...)`` emit, after every chunk of
steps, a resumable dict of host arrays: ``dof``, ``step``, ``losses``,
``history`` and the optimizer state as ``opt_0..opt_N`` in optax leaf order
(Adam: count, mu, nu, schedule count; SGD: trace, schedule count). The port
keeps optax's leaves (solver/optim.py), so converting is a matter of
checking the leaves and normalizing dtypes and shapes — after which a run
interrupted in either package resumes in the other.

The U-Net segmenter's weights cross as the flax parameter tree both
packages' ``save_params`` pickle (plain dicts of numpy arrays):
``unet_state_from_flax`` and ``unet_state_to_flax`` map it to and from the
port's ``UNet.state_dict()`` (conv kernels HWIO <-> OIHW).

This module imports neither JAX nor easyhec_tpu; the JAX side is handed in
as plain dicts and as a renderer object whose arrays numpy can read.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .robot.mesh import TriMesh

__all__ = [
    "state_from_jax",
    "state_to_jax",
    "renderer_static_arrays",
    "check_renderer_static",
    "unet_state_from_flax",
    "unet_state_to_flax",
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


# flax module path <-> UNet.state_dict() prefix: _ConvBlock_i -> blocks.i,
# its Conv_j / GroupNorm_j -> convj / gnj; the top-level 1x1 Conv_0 -> head.
_FLAX_LEAF = {("conv", "kernel"): "weight", ("conv", "bias"): "bias",
              ("gn", "scale"): "weight", ("gn", "bias"): "bias"}


def unet_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A flax U-Net parameter tree ({'params': {...}}, numpy or jax leaves)
    -> the port's UNet state dict (f32 tensors on the CPU)."""
    out = {}
    for mod, leaves in tree["params"].items():
        if mod == "Conv_0":
            items = [("head", "conv", leaves)]
        else:
            i = int(re.fullmatch(r"_ConvBlock_(\d+)", mod).group(1))
            items = []
            for sub, sl in leaves.items():
                kind, j = re.fullmatch(r"(Conv|GroupNorm)_(\d+)", sub).groups()
                kind = "conv" if kind == "Conv" else "gn"
                items.append((f"blocks.{i}.{kind}{j}", kind, sl))
        for prefix, kind, sl in items:
            for name, a in sl.items():
                a = np.array(a, np.float32)
                if name == "kernel":
                    a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                out[f"{prefix}.{_FLAX_LEAF[kind, name]}"] = torch.from_numpy(
                    np.ascontiguousarray(a))
    return out


def unet_state_to_flax(state: dict) -> dict:
    """The port's UNet state dict -> the flax parameter tree of numpy arrays
    that easyhec_tpu's load_params and SegmenterMaskSource read."""
    params: dict = {}
    for key, t in state.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        parts = key.split(".")
        if parts[0] == "head":
            mod, kind, leaf = params.setdefault("Conv_0", {}), "conv", parts[1]
        else:
            block = params.setdefault(f"_ConvBlock_{parts[1]}", {})
            kind, j = re.fullmatch(r"(conv|gn)(\d+)", parts[2]).groups()
            mod = block.setdefault(f"{'Conv' if kind == 'conv' else 'GroupNorm'}_{j}", {})
            leaf = parts[3]
        if kind == "conv":
            name = "kernel" if leaf == "weight" else "bias"
            if name == "kernel":
                a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            name = "scale" if leaf == "weight" else "bias"
        mod[name] = np.ascontiguousarray(a)
    return {"params": params}
