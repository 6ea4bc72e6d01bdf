"""Typed configuration tree.

Copy of easyhec_tpu/config/config.py: the same dataclass tree, defaults and
dotted CLI overrides, so one configuration file drives either package. Two
differences: PyYAML is imported only inside the functions that parse YAML
(so ``Config`` imports on a machine without it), and ``save_config`` writes
JSON, which is YAML too, so both packages' ``load_config`` read it.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

__all__ = [
    "Config",
    "ModelConfig",
    "SolverConfig",
    "DatasetConfig",
    "ExplorerConfig",
    "RenderConfig",
    "load_config",
    "save_config",
    "apply_overrides",
]


@dataclass
class RenderConfig:
    tile_h: int = 32
    tile_w: int = 128
    capacity: int = 512  # triangles per tile bin (keep <= 512, tiled.py note)
    use_pallas: bool = True
    mode: str = "tiled"  # "tiled" | "brute"
    sharpness: float = 1.0
    binner: str = "count"  # "count" (counting sort) | "topk"
    rect_y: int = 0  # count-binner tile-rect window; 0 = auto/full (exact)
    rect_x: int = 0
    margin: float = 2.0  # bbox dilation px (soft band + rebin drift budget)
    cull_backfaces: bool = False  # exact only for closed oriented meshes
    fused: bool = True  # fused-pose kernel (render/fused.py): per-rebin
    #                     records, in-kernel projection/setup, analytic
    #                     d(loss)/d(Tc) — gradients through the camera pose
    #                     only (the calibration contract)
    bwd_band_only: bool = True  # backward gradients from silhouette-BAND
    #                     pixels only (interior internal-edge pairs cancel in
    #                     pose space — exact to roundoff, lets interior tiles
    #                     skip their backward; tests/test_fused.py
    #                     TestBandOnlyBackward). Deliberately True here and
    #                     False in the raw TileConfig: trainers get the
    #                     production contract, the kernel layer keeps
    #                     unmodified semantics for oracle tests (see
    #                     render/tiled.py TileConfig.bwd_band_only)
    bin_big_k: int = 0  # span-classed binning (binning.bin_count): 0 = dense
    #                     enumeration; >0 = 2 entries per small triangle +
    #                     full window for up to bin_big_k large ones (~4x
    #                     cheaper rebinning at production scale)
    bin_subsort_rows: bool = False  # row-coherent bin ordering (see
    #                     render/tiled.py TileConfig.bin_subsort_rows)
    compact_chunks: int = 0  # >0: compact-chunk-grid loss path — records
    #                     packed contiguously into this many 128-slot
    #                     chunks; rebin gather + kernel grid scale with
    #                     occupancy instead of n_tiles*capacity (see
    #                     ops/pose_raster_compact.py). 0 = dense records
    bwd_chunks: int = 0  # >0 (with compact_chunks + bwd_band_only): the
    #                     backward runs on a reduced chunk map over
    #                     boundary-band-capable tiles only, classified per
    #                     rebin (render/fused.build_compact_state). Static
    #                     chunk budget; overflow flags if exceeded


@dataclass
class ModelConfig:
    """The RBSolver-equivalent pose model (reference:
    easyhec/modeling/models/rb_solve/rb_solver.py + configs/*/example*.yaml)."""

    urdf_path: str = ""
    mesh_paths: list[str] = field(default_factory=list)  # optional explicit meshes
    use_links: list[str] = field(default_factory=list)  # link names to render
    init_Tc_c2b: list[list[float]] | None = None  # 4x4 row-major; None = from dataset/lookat
    # Initial-pose source: "auto" (init_Tc_c2b > dataset GT > global_search),
    # "manual" (init_Tc_c2b required), "gt", "lookat" (init_lookat_eye/target),
    # "global_search" (render-and-score search, the PVNet-initializer role —
    # reference trainer/rbsolve_iter.py:324-340)
    init_method: str = "auto"
    init_lookat_eye: list[float] | None = None
    init_lookat_target: list[float] | None = None
    H: int = 480
    W: int = 640
    decimate_voxel: float = 0.0  # >0: vertex-clustering mesh decimation (m)
    subdivide_max_edge: float = 0.0  # >0: split triangles to this max edge (m)
    history_size: int = 10000  # pose-hypothesis ring buffer (reference: rb_solver.py:39)


@dataclass
class SolverConfig:
    optimizer: str = "adam"  # adam | sgd
    max_lr: float = 3e-3  # reference default (configs/xarm7/example.yaml:44)
    scheduler: str = "constant"  # constant | cosine | exponential | onecycle
    num_epochs: int = 1000  # optimization steps per round (1 step = full batch)
    explore_iters: int = 5
    grad_clip: float = 0.0  # 0 = off
    robust_delta: float = 0.0  # >0: Huber downweighting of outlier frames
    rebin_every: int = 0  # 0 = ADAPTIVE rebinning (bins rebuilt exactly
    #                 when pose drift exceeds the binning-margin budget —
    #                 drift-exact for every render and faster than any
    #                 fixed cadence); N > 0 = rebuild every N steps
    weight_decay: float = 0.0
    log_interval: int = 100
    save_freq: int = 100
    seed: int = 0
    load: str = ""  # "latest" resumes from the newest mid-run checkpoint in
    #                 output_dir/checkpoints (reference base.py:420-440)


@dataclass
class DatasetConfig:
    data_dir: str = ""  # layout: color/ mask/ qpos/ K.txt [Tc_c2b.txt]
    batch_size: int = 0  # 0 = all frames in one batch (reference semantics)


@dataclass
class ExplorerConfig:
    """Space-exploration next-pose selection (reference:
    easyhec/modeling/models/rb_solve/space_explorer.py)."""

    n_sample_qposes: int = 1000
    n_hypotheses: int = 10  # historical pose hypotheses ("sample" in reference)
    history_start: int = 200  # burn-in steps dropped from history
    max_dist: float = 0.5  # max link distance from workspace center
    max_dist_constraint: bool = True
    self_collision_check: bool = True
    render_downscale: int = 2  # score renders at H/ds x W/ds
    decimate_voxel: float = 0.0  # explorer-renderer mesh LOD; 0 = auto
    #                       (model.decimate_voxel * render_downscale). A
    #                       sub-pixel-triangle mesh at 1/ds resolution
    #                       concentrates thousands of triangles per tile
    #                       (audited 6900/tile at 320x180 with the full-res
    #                       mesh) — variance scoring is insensitive to
    #                       sub-pixel detail, so the LOD matches the pixels
    seed: int = 0
    plan_top_k: int = 10  # try planning to the top-k candidates by variance
    #                       until one succeeds (reference gates EVERY scored
    #                       candidate on plan feasibility, space_explorer.py:
    #                       123-137; planning only the best k preserves the
    #                       plan-or-skip safety contract at 1/100 the cost)
    use_workspace_boundary: bool = True  # feed the env obstacle cloud
    #                       (io/workspace.py) to the motion planner, like the
    #                       reference's planner.add_point_cloud
    workspace_table_z: float = 0.0  # table plane height for the obstacle cloud


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    explorer: ExplorerConfig = field(default_factory=ExplorerConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    output_dir: str = "runs/default"
    dbg: bool = False


def _update_dataclass(obj: Any, data: dict) -> Any:
    for k, v in data.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update_dataclass(cur, v)
        else:
            setattr(obj, k, v)
    return obj


def load_config(path: str | Path | None = None, overrides: list[str] | None = None) -> Config:
    cfg = Config()
    if path is not None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _update_dataclass(cfg, data)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Dotted-path CLI overrides: ["solver.max_lr=0.01", "model.H=720"]; each
    value is parsed as YAML."""
    import yaml

    for item in overrides:
        key, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} must be key=value")
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        getattr(obj, parts[-1])  # unknown keys raise AttributeError
        val = yaml.safe_load(raw)
        setattr(obj, parts[-1], val)
    return cfg


def save_config(cfg: Config, path: str | Path) -> None:
    """Write cfg as JSON (a YAML subset: load_config reads it back)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
