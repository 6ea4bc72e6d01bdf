"""ctypes bindings for the native ezplan library (native/ezplan.cpp).

Drop-in accelerated backend for easyhec_torch.io.planner (the pure-Python
RRT/collision implementation stays as the behavioral reference and
fallback). `plan_to_qpos_native` mirrors `planner.plan_to_qpos`, returning
the same plan contract dict. Copy of easyhec_tpu/io/native_planner.py: it
loads the same library, native/libezplan.so, built with ``make -C native``
at first use when it is missing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..models.explorer import LinkSpheres
from ..robot import KinematicChain
from .planner import time_parameterize

__all__ = ["NativePlanner", "native_available", "plan_to_qpos_native"]

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / "libezplan.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        import subprocess

        try:  # build on first use if the toolchain is present
            subprocess.run(
                ["make", "-C", str(_LIB_PATH.parent)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.ezplan_create.restype = ctypes.c_void_p
    lib.ezplan_create.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
    ]
    lib.ezplan_add_spheres.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
        ctypes.c_int,
    ]
    lib.ezplan_set_pair_check.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint8), ctypes.c_int
    ]
    lib.ezplan_set_env.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64), ctypes.c_int, ctypes.c_double
    ]
    lib.ezplan_in_collision.restype = ctypes.c_int
    lib.ezplan_in_collision.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64)]
    lib.ezplan_fk.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64)
    ]
    lib.ezplan_plan.restype = ctypes.c_int
    lib.ezplan_plan.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_uint64,
        np.ctypeslib.ndpointer(np.float64), ctypes.c_int,
    ]
    lib.ezplan_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativePlanner:
    """Native chain + collision + RRT. Mirrors io.planner's semantics."""

    def __init__(
        self,
        chain: KinematicChain,
        spheres: LinkSpheres,
        env_points: np.ndarray | None = None,
        env_margin: float = 0.02,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("libezplan.so unavailable (build native/ with make)")
        self._lib = lib
        self.chain = chain
        specs = chain._specs
        n_links = len(specs)
        parent = np.asarray([s.parent_index for s in specs], np.int32)
        jtype = np.asarray([s.joint_type for s in specs], np.int32)
        origins = np.stack([s.origin.astype(np.float64) for s in specs]).reshape(n_links, 16)
        axes = np.stack([s.axis.astype(np.float64) for s in specs])
        qidx = np.asarray([s.qpos_index for s in specs], np.int32)
        mm = np.asarray([s.mimic_multiplier for s in specs], np.float64)
        mo = np.asarray([s.mimic_offset for s in specs], np.float64)
        limits = chain.joint_limits.astype(np.float64)
        self._h = lib.ezplan_create(
            chain.n_dof, n_links, parent, jtype,
            np.ascontiguousarray(origins), np.ascontiguousarray(axes), qidx,
            mm, mo, np.ascontiguousarray(limits[:, 0]), np.ascontiguousarray(limits[:, 1]),
        )
        for i in range(spheres.centers.shape[0]):
            lib.ezplan_add_spheres(
                self._h,
                int(spheres.link_indices[i]),
                np.ascontiguousarray(spheres.centers[i].astype(np.float64)),
                np.ascontiguousarray(spheres.radii[i].astype(np.float64)),
                spheres.centers.shape[1],
            )
        lib.ezplan_set_pair_check(
            self._h,
            np.ascontiguousarray(spheres.pair_mask.astype(np.uint8)),
            spheres.centers.shape[0],
        )
        if env_points is not None and len(env_points):
            lib.ezplan_set_env(
                self._h,
                np.ascontiguousarray(np.asarray(env_points, np.float64)),
                len(env_points),
                env_margin,
            )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ezplan_destroy(self._h)
            self._h = None

    def in_collision(self, qpos) -> bool:
        q = np.ascontiguousarray(np.asarray(qpos, np.float64))
        return bool(self._lib.ezplan_in_collision(self._h, q))

    def fk(self, qpos) -> np.ndarray:
        q = np.ascontiguousarray(np.asarray(qpos, np.float64))
        out = np.zeros((len(self.chain._specs), 16), np.float64)
        self._lib.ezplan_fk(self._h, q, out)
        return out.reshape(-1, 4, 4).astype(np.float32)

    def plan_path(
        self,
        q_start,
        q_goal,
        step: float = 0.2,
        max_iters: int = 2000,
        goal_bias: float = 0.1,
        seed: int = 0,
        max_pts: int = 256,
    ) -> list[np.ndarray] | None:
        qs = np.ascontiguousarray(np.asarray(q_start, np.float64))
        qg = np.ascontiguousarray(np.asarray(q_goal, np.float64))
        out = np.zeros((max_pts, self.chain.n_dof), np.float64)
        n = self._lib.ezplan_plan(
            self._h, qs, qg, step, max_iters, goal_bias, seed, out, max_pts
        )
        if n == 0:
            return None
        return [out[i].copy() for i in range(n)]


def plan_to_qpos_native(
    chain: KinematicChain,
    spheres: LinkSpheres,
    q_start,
    q_goal,
    env_points=None,
    v_max: float = 0.3,
    a_max: float = 1.0,
    dt: float = 0.05,
    seed: int = 0,
) -> dict:
    planner = NativePlanner(chain, spheres, env_points)
    path = planner.plan_path(q_start, q_goal, seed=seed)
    if path is None:
        return {"status": "Failure", "duration": 0.0}
    return time_parameterize(path, v_max=v_max, a_max=a_max, dt=dt)
