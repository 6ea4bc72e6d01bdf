"""Host-side motion planning: RRT-Connect + shortcut smoothing + trapezoidal
time parameterization.

Numpy copy of easyhec_tpu/io/planner.py: the same collision model, RRT and
timing, drawing from ``np.random.default_rng(seed)``, so a plan equals the
JAX package's bit for bit.

Replaces the reference's mplib/OMPL planner + TOPP
(easyhec/modeling/models/rb_solve/collision_checker.py:58-105). Output dict
matches the reference's plan result contract:
{"status", "time", "position", "velocity", "acceleration", "duration"} so the
arm-driving loop (reference trainer/rbsolve_iter.py:191-217) ports directly.

Collision model: the same sphere approximation used by the explorer
(easyhec_torch.models.explorer.LinkSpheres) against self-collision and an
optional environment point cloud (the reference feeds a workspace boundary
cloud, workspace_boundary.py:8-24).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.explorer import LinkSpheres
from ..robot import KinematicChain

__all__ = [
    "CollisionModel", "RRTPlanner", "time_parameterize", "plan_to_qpos",
    "plan_first_feasible",
]


@dataclass
class CollisionModel:
    chain: KinematicChain
    spheres: LinkSpheres
    env_points: np.ndarray | None = None  # [N, 3] obstacle cloud
    env_margin: float = 0.02

    def in_collision(self, qpos: np.ndarray) -> bool:
        poses = self.chain.fk_np(qpos)[self.spheres.link_indices]  # [L, 4, 4]
        R, t = poses[:, :3, :3], poses[:, :3, 3]
        c = np.einsum("lij,lsj->lsi", R, self.spheres.centers) + t[:, None, :]
        r = self.spheres.radii
        L = c.shape[0]
        # self collision
        d = np.linalg.norm(c[:, :, None, None, :] - c[None, None, :, :, :], axis=-1)
        rsum = r[:, :, None, None] + r[None, None, :, :]
        exists = (r > 0)[:, :, None, None] & (r > 0)[None, None, :, :]
        pair = self.spheres.pair_mask[:, None, :, None]
        if np.any((d - rsum < 0) & exists & pair):
            return True
        # environment
        if self.env_points is not None and len(self.env_points):
            dc = np.linalg.norm(
                c[:, :, None, :] - self.env_points[None, None, :, :], axis=-1
            )
            if np.any((dc - r[:, :, None] < self.env_margin) & (r > 0)[:, :, None]):
                return True
        return False

    def segment_free(self, q0: np.ndarray, q1: np.ndarray, step: float = 0.05) -> bool:
        dist = float(np.linalg.norm(q1 - q0))
        n = max(int(np.ceil(dist / step)), 1)
        for i in range(n + 1):
            if self.in_collision(q0 + (q1 - q0) * (i / n)):
                return False
        return True


@dataclass
class RRTPlanner:
    """RRT-Connect in joint space with greedy shortcut smoothing."""

    model: CollisionModel
    step: float = 0.2  # extension step (rad)
    max_iters: int = 2000
    goal_bias: float = 0.1
    seed: int = 0

    def plan(self, q_start: np.ndarray, q_goal: np.ndarray) -> list[np.ndarray] | None:
        rng = np.random.default_rng(self.seed)
        limits = self.model.chain.joint_limits.astype(np.float64)
        q_start = np.asarray(q_start, np.float64)
        q_goal = np.asarray(q_goal, np.float64)
        if self.model.in_collision(q_goal):
            return None
        if self.model.segment_free(q_start, q_goal):
            return [q_start, q_goal]

        nodes = [q_start]
        parents = [-1]
        for _ in range(self.max_iters):
            if rng.random() < self.goal_bias:
                target = q_goal
            else:
                target = rng.uniform(limits[:, 0], limits[:, 1])
            dists = np.linalg.norm(np.asarray(nodes) - target, axis=1)
            ni = int(np.argmin(dists))
            q_near = nodes[ni]
            delta = target - q_near
            dist = float(np.linalg.norm(delta))
            q_new = target if dist <= self.step else q_near + delta * (self.step / dist)
            if not self.model.segment_free(q_near, q_new, step=self.step / 2):
                continue
            nodes.append(q_new)
            parents.append(ni)
            if np.linalg.norm(q_new - q_goal) < 1e-9 or (
                self.model.segment_free(q_new, q_goal)
            ):
                nodes.append(q_goal)
                parents.append(len(nodes) - 2)
                break
        else:
            return None

        # Extract path
        path = []
        i = len(nodes) - 1
        while i >= 0:
            path.append(nodes[i])
            i = parents[i]
        path.reverse()
        return self._shortcut(path, rng)

    def _shortcut(self, path: list[np.ndarray], rng, rounds: int = 50) -> list[np.ndarray]:
        path = list(path)
        for _ in range(rounds):
            if len(path) <= 2:
                break
            i, j = sorted(rng.choice(len(path), 2, replace=False))
            if j - i > 1 and self.model.segment_free(path[i], path[j]):
                path = path[: i + 1] + path[j:]
        return path


def time_parameterize(
    path: list[np.ndarray],
    v_max: float = 0.3,
    a_max: float = 1.0,
    dt: float = 0.05,
) -> dict:
    """Trapezoidal velocity profile along the piecewise-linear joint path.

    Returns the reference plan contract: status/time/position/velocity/
    acceleration/duration (collision_checker.py:96-105).
    """
    path = [np.asarray(p, np.float64) for p in path]
    # Arc length in joint space (inf-norm so v_max bounds every joint)
    seg = [float(np.abs(path[i + 1] - path[i]).max()) for i in range(len(path) - 1)]
    total = sum(seg)
    if total < 1e-12:
        q = path[0][None]
        return {
            "status": "Success",
            "time": np.zeros(1),
            "position": q,
            "velocity": np.zeros_like(q),
            "acceleration": np.zeros_like(q),
            "duration": 0.0,
        }
    # Trapezoid over total arc length s in [0, total]
    t_acc = v_max / a_max
    s_acc = 0.5 * a_max * t_acc**2
    if 2 * s_acc > total:  # triangular profile
        t_acc = float(np.sqrt(total / a_max))
        s_acc = total / 2
        v_peak = a_max * t_acc
        duration = 2 * t_acc
    else:
        v_peak = v_max
        duration = 2 * t_acc + (total - 2 * s_acc) / v_max

    times = np.arange(0.0, duration + dt, dt)

    def s_of_t(t):
        if t < t_acc:
            return 0.5 * a_max * t * t
        if t > duration - t_acc:
            td = duration - t
            return total - 0.5 * a_max * td * td
        return s_acc + v_peak * (t - t_acc)

    cum = np.concatenate([[0.0], np.cumsum(seg)])

    def q_of_s(s):
        s = min(max(s, 0.0), total)
        k = int(np.searchsorted(cum, s, side="right") - 1)
        k = min(k, len(seg) - 1)
        f = (s - cum[k]) / max(seg[k], 1e-12)
        return path[k] + (path[k + 1] - path[k]) * f

    qs = np.stack([q_of_s(s_of_t(t)) for t in times])
    vel = np.gradient(qs, dt, axis=0)
    acc = np.gradient(vel, dt, axis=0)
    return {
        "status": "Success",
        "time": times,
        "position": qs,
        "velocity": vel,
        "acceleration": acc,
        "duration": float(duration),
    }


def plan_to_qpos(
    chain: KinematicChain,
    spheres: LinkSpheres,
    q_start: np.ndarray,
    q_goal: np.ndarray,
    env_points: np.ndarray | None = None,
    v_max: float = 0.3,
    a_max: float = 1.0,
    dt: float = 0.05,
    seed: int = 0,
) -> dict:
    """One-call plan: RRT-Connect + smoothing + trapezoidal timing."""
    model = CollisionModel(chain, spheres, env_points)
    planner = RRTPlanner(model, seed=seed)
    path = planner.plan(q_start, q_goal)
    if path is None:
        return {"status": "Failure", "duration": 0.0}
    return time_parameterize(path, v_max=v_max, a_max=a_max, dt=dt)


def plan_first_feasible(
    chain: KinematicChain,
    spheres: LinkSpheres,
    q_start: np.ndarray,
    candidates,
    env_points: np.ndarray | None = None,
    seed: int = 0,
    **plan_kwargs,
) -> tuple[np.ndarray | None, dict | None]:
    """Plan to the first plannable candidate, in order.

    The explorer's plan-feasibility gate (reference space_explorer.py:
    97-137 gates every scored candidate on plan success; planning the
    variance-ranked top-k until one succeeds preserves the plan-or-skip
    safety contract). Returns (qpos, plan) of the first success, or
    (None, None) if no candidate is plannable — callers must then SKIP the
    move, never command an unplanned one.
    """
    for cand in candidates:
        cand = np.asarray(cand, np.float32)
        plan = plan_to_qpos(
            chain, spheres, q_start, cand, env_points=env_points,
            seed=seed, **plan_kwargs,
        )
        if plan.get("status") == "Success":
            return cand, plan
    return None, None
