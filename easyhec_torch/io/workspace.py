"""Workspace boundary obstacle clouds for the motion planner.

Numpy copy of easyhec_tpu/io/workspace.py (the port imports nothing of the
JAX package); the same seeds give the same clouds bit for bit.

Parity with the reference's hard-coded lab workspace generator
(easyhec/modeling/models/rb_solve/workspace_boundary.py:8-24: box-surface
samples + table-plane samples -> ~5k points fed to the planner as
obstacles). Here the box/table are parameters instead of constants, and the
sampling is deterministic per seed.
"""
from __future__ import annotations

import numpy as np

__all__ = ["workspace_boundary_points", "table_points", "box_surface_points"]


def box_surface_points(
    box_min, box_max, n: int = 4000, seed: int = 0
) -> np.ndarray:
    """Uniform samples on the 6 faces of an axis-aligned box [n, 3]."""
    lo = np.asarray(box_min, np.float64)
    hi = np.asarray(box_max, np.float64)
    size = hi - lo
    # Face areas decide how many samples each face gets.
    areas = np.array(
        [
            size[1] * size[2], size[1] * size[2],
            size[0] * size[2], size[0] * size[2],
            size[0] * size[1], size[0] * size[1],
        ]
    )
    weights = areas / areas.sum()
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(n, weights)
    pts = []
    for face, cnt in enumerate(counts):
        if cnt == 0:
            continue
        axis = face // 2  # fixed axis
        side = face % 2  # 0 = lo face, 1 = hi face
        p = rng.uniform(lo, hi, (cnt, 3))
        p[:, axis] = hi[axis] if side else lo[axis]
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def table_points(
    z: float = 0.0,
    x_range=(-1.0, 1.0),
    y_range=(-1.0, 1.0),
    n: int = 1000,
    seed: int = 1,
) -> np.ndarray:
    """Uniform samples on the table plane z=const [n, 3]."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(
        [x_range[0], y_range[0]], [x_range[1], y_range[1]], (n, 2)
    )
    return np.concatenate(
        [xy, np.full((n, 1), z)], axis=1
    ).astype(np.float32)


def workspace_boundary_points(
    box_min=(-0.7, -0.7, -0.02),
    box_max=(0.7, 0.7, 1.0),
    table_z: float = 0.0,
    n_box: int = 4000,
    n_table: int = 1000,
    seed: int = 0,
    base_clear_radius: float = 0.2,
) -> np.ndarray:
    """Box-surface + table-plane obstacle cloud (~n_box + n_table points).

    Defaults approximate the reference's lab workspace scale; pass the real
    cell geometry in production. Feed to CollisionModel.env_points /
    plan_to_qpos so exploration never plans through walls or the table
    (reference space_explorer.py:97-98). Table points within
    base_clear_radius of the robot base are dropped so the base mount never
    reads as colliding with its own table (reference keeps norm > 0.1,
    workspace_boundary.py:19-20; the default is larger because the sphere
    collision model is more conservative than FCL meshes).
    """
    box = box_surface_points(box_min, box_max, n_box, seed)
    # Table samples only outside the box footprint contribute information,
    # but keeping all of them matches the reference's flat union.
    tbl = table_points(
        table_z,
        (box_min[0] - 0.3, box_max[0] + 0.3),
        (box_min[1] - 0.3, box_max[1] + 0.3),
        n_table,
        seed + 1,
    )
    if base_clear_radius > 0:
        tbl = tbl[np.linalg.norm(tbl[:, :2], axis=1) > base_clear_radius]
    return np.concatenate([box, tbl])
