"""Offline calibration runner.

Counterpart of easyhec_tpu/trainer/offline.py: build robot, renderer and
dataset from the config, run ``calibrate``, and write the artifacts (solved
pose, metrics, loss trace, evaluators, checkpoints, error maps). Runs on
CUDA unless the caller passes ``device="cpu"``.

Unlike the JAX trainer, rendering and the evaluators run outside any
catch-all: a failing silhouette kernel stops the run. Only the matplotlib
panels are optional (skipped with a warning when matplotlib is absent).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..config.config import Config, save_config
from ..data.dataset import CalibBatch, load_calib_dataset
from ..evaluators import build_evaluators
from ..geometry import se3
from ..models.calib import BinOverflowError, CalibResult, calibrate, render_outputs
from ..render.renderer import RobotRenderer
from ..render.tiled import TileConfig
from ..robot import build_chain, load_link_meshes, load_mesh, parse_urdf
from ..robot.mesh import decimate_vertex_clustering, subdivide_to_max_edge
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.live import write_dashboard
from ..utils.logging import LOGGER, MetricsWriter, setup_logger

__all__ = ["Runtime", "build_runtime", "escalate_render_budgets", "run_offline_calibration"]


@dataclasses.dataclass
class Runtime:
    """Everything the trainer needs, built once from the config."""

    chain: object
    renderer: RobotRenderer
    link_names: list[str]
    cfg: Config


def build_runtime(cfg: Config, device=None) -> Runtime:
    """Robot chain, processed link meshes and renderer (on ``device``; None
    means CUDA) from cfg.model and cfg.render."""
    model = parse_urdf(cfg.model.urdf_path)
    chain = build_chain(model)
    if cfg.model.mesh_paths:
        if not cfg.model.use_links:
            raise ValueError("mesh_paths given but use_links empty")
        link_names = list(cfg.model.use_links)
        meshes = [load_mesh(p) for p in cfg.model.mesh_paths]
    else:
        link_names = list(cfg.model.use_links) or [l.name for l in model.links if l.visuals]
        mesh_map = load_link_meshes(model, link_names=link_names)
        link_names = [n for n in link_names if n in mesh_map]
        meshes = [mesh_map[n] for n in link_names]
    if not meshes:
        raise ValueError("no link meshes resolved; check urdf/mesh_paths config")
    if cfg.model.decimate_voxel > 0:
        meshes = [decimate_vertex_clustering(m, cfg.model.decimate_voxel) for m in meshes]
    if cfg.model.subdivide_max_edge > 0:
        meshes = [subdivide_to_max_edge(m, cfg.model.subdivide_max_edge) for m in meshes]
    r = cfg.render
    tile = TileConfig(
        r.tile_h, r.tile_w, r.capacity, r.use_pallas, binner=r.binner,
        rect_y=r.rect_y, rect_x=r.rect_x, margin=r.margin,
        cull_backfaces=r.cull_backfaces, fused=r.fused,
        bwd_band_only=r.bwd_band_only, bin_big_k=r.bin_big_k,
        bin_subsort_rows=r.bin_subsort_rows, compact_chunks=r.compact_chunks,
        bwd_chunks=r.bwd_chunks,
    )
    renderer = RobotRenderer(meshes, cfg.model.H, cfg.model.W, tile=tile, mode=r.mode,
                             device=device)
    return Runtime(chain=chain, renderer=renderer, link_names=link_names, cfg=cfg)


def _warn_if_bins_overflow(rt: Runtime, batch: CalibBatch, init_dof) -> None:
    """Log a warning when frame 0's bin state at the initial pose overflows
    (a saturated tile bin, or a triangle rect beyond the static window), as
    the JAX trainer checks frame 0. calibrate itself checks every frame at
    every rebin of the trajectory and escalates."""
    r = rt.renderer
    dev = r.device
    Tc = se3.exp(torch.as_tensor(np.asarray(init_dof), dtype=torch.float32, device=dev))
    lp = torch.as_tensor(batch.link_poses[:1], dtype=torch.float32, device=dev)
    K = torch.as_tensor(batch.K, dtype=torch.float32, device=dev)
    st = r.bin_state(Tc, lp, K, sharpness=rt.cfg.render.sharpness)
    if bool(torch.any(st.overflow)):
        logging.getLogger(LOGGER).warning(
            "rasterizer bin overflow at the initial pose: some triangles would be "
            "dropped. Raise render.capacity / compact_chunks, set "
            "render.rect_y/rect_x to cover larger triangles, or increase "
            "model.decimate_voxel."
        )


def escalate_render_budgets(cfg: Config) -> None:
    """Double the static bin budgets after a BinOverflowError (capacity to
    the next multiple of 128; compact/bwd chunk budgets and the big-span
    class along with it)."""
    r = cfg.render
    r.capacity = -(-r.capacity * 2 // 128) * 128
    if r.compact_chunks > 0:
        r.compact_chunks *= 2
    if r.bwd_chunks > 0:
        r.bwd_chunks *= 2
    if r.bin_big_k > 0:
        r.bin_big_k *= 2


def _init_dof(cfg: Config, batch: CalibBatch) -> np.ndarray:
    """Initial se(3) pose per cfg.model.init_method: "manual" / "auto" from
    init_Tc_c2b, "lookat" from init_lookat_eye/target, "gt" / "auto" from the
    dataset's ground truth. The render-and-score search ("global_search", and
    "auto" with neither a pose nor GT) is not ported: it raises."""
    method = cfg.model.init_method
    T = None
    if method in ("manual", "auto") and cfg.model.init_Tc_c2b is not None:
        T = np.asarray(cfg.model.init_Tc_c2b, dtype=np.float32).reshape(4, 4)
    elif method == "lookat":
        from ..models.pose_init import lookat_init

        if cfg.model.init_lookat_eye is None or cfg.model.init_lookat_target is None:
            raise ValueError("init_method=lookat needs init_lookat_eye/target")
        T = lookat_init(cfg.model.init_lookat_eye, cfg.model.init_lookat_target)
    elif method in ("gt", "auto") and batch.has_gt:
        T = batch.Tc_c2b_gt
    if T is None and method in ("global_search", "auto"):
        raise NotImplementedError(
            f"init_method={method!r} needs global_search_init, which is not ported "
            "to easyhec_torch yet (ROADMAP.md queue item 12, pose init): set "
            "model.init_Tc_c2b, use init_method=lookat, or provide dataset GT"
        )
    if T is None:
        raise ValueError(
            f"no initial pose for init_method={method!r}: set model.init_Tc_c2b "
            "or provide dataset GT"
        )
    return se3.log(torch.as_tensor(np.asarray(T, np.float32))).numpy()


def run_offline_calibration(
    cfg: Config, batch: CalibBatch | None = None, init_dof: np.ndarray | None = None,
    device=None,
) -> CalibResult:
    """Calibrate from cfg (dataset from cfg.dataset.data_dir unless ``batch``
    is given; initial pose per cfg.model.init_method unless ``init_dof`` is)
    and write the run's artifacts under cfg.output_dir."""
    logger = setup_logger(cfg.output_dir)
    out = Path(cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_config(cfg, out / "config.yaml")

    rt = build_runtime(cfg, device)
    if batch is None:
        batch = load_calib_dataset(cfg.dataset.data_dir, rt.chain, rt.link_names)
    logger.info("dataset: %d frames %dx%d, links=%s", batch.n_frames, cfg.model.H,
                cfg.model.W, rt.link_names)
    if init_dof is None:
        init_dof = _init_dof(cfg, batch)
    _warn_if_bins_overflow(rt, batch, init_dof)

    ckpt_dir = out / "checkpoints"
    resume_state = None
    if cfg.solver.load == "latest":
        mid = ckpt_dir / "midrun.npz"
        if mid.exists():
            resume_state, _ = load_checkpoint(mid)
            logger.info("resuming from %s at step %d", mid, int(resume_state["step"]))

    mid_writer = MetricsWriter(out)
    write_dashboard(out)

    def step_hook(done, state):
        ls = state.get("losses")
        if ls is not None and len(ls):
            mid_writer.scalars(done, mask_loss=float(ls[-1]))
        if cfg.solver.save_freq and (
            done % cfg.solver.save_freq == 0 or done >= cfg.solver.num_epochs
        ):
            save_checkpoint(ckpt_dir / "midrun", state, meta={"step": done})
        if cfg.solver.log_interval and done % cfg.solver.log_interval == 0:
            outs = render_outputs(state["dof"], rt.renderer, batch.link_poses[:1],
                                  batch.K, batch.masks[:1])
            mid_writer.image(done, "error_map", outs["error_maps"][0])
            mid_writer.image(done, "rendered", outs["rendered_masks"][0])

    t0 = time.time()
    # calibrate checks the overflow flag at every rebin of the trajectory; on
    # overflow the bin budgets double and the run restarts, up to 3 attempts.
    for attempt in range(3):
        try:
            result = calibrate(
                init_dof, rt.renderer, batch.link_poses, batch.K, batch.masks,
                num_steps=cfg.solver.num_epochs, max_lr=cfg.solver.max_lr,
                optimizer=cfg.solver.optimizer, scheduler=cfg.solver.scheduler,
                grad_clip=cfg.solver.grad_clip, sharpness=cfg.render.sharpness,
                robust_delta=cfg.solver.robust_delta,
                rebin_every=cfg.solver.rebin_every,
                Tc_c2b_gt=batch.Tc_c2b_gt if batch.has_gt else None,
                resume_state=resume_state, step_hook=step_hook,
            )
            break
        except BinOverflowError as e:
            if resume_state is not None or attempt == 2:
                raise
            escalate_render_budgets(cfg)
            logger.warning("%s — escalating to capacity=%d compact_chunks=%d and "
                           "restarting", e, cfg.render.capacity, cfg.render.compact_chunks)
            rt = build_runtime(cfg, device)
    mid_writer.close()
    dt = time.time() - t0
    logger.info("calibrated %d steps in %.1fs (%.1f steps/s); final loss %.4f",
                cfg.solver.num_epochs, dt, cfg.solver.num_epochs / dt, result.losses[-1])
    if result.metrics:
        logger.info("metrics vs GT: %s", json.dumps(result.metrics))

    writer = MetricsWriter(out)
    for s in range(0, len(result.losses), max(1, cfg.solver.log_interval)):
        writer.scalars(s, mask_loss=float(result.losses[s]))
    writer.close()
    np.savetxt(out / "Tc_c2b.txt", result.Tc_c2b)
    (out / "metrics.json").write_text(json.dumps(result.metrics, indent=2))
    save_checkpoint(
        ckpt_dir / "final",
        {"dof": result.dof, "history": result.history, "losses": result.losses},
        meta={"num_steps": cfg.solver.num_epochs, "wall_time_s": dt},
    )
    outputs = render_outputs(result.dof, rt.renderer, batch.link_poses, batch.K,
                             batch.masks)
    _save_error_panel(out / "error_maps.png", outputs)
    outputs["dof"] = result.dof
    eval_metrics: dict[str, float] = {}
    for ev in build_evaluators(["mask_iou", "pose_error"]):
        eval_metrics.update(ev(outputs, batch))
    if eval_metrics:
        logger.info("evaluators: %s", json.dumps(eval_metrics))
        (out / "eval.json").write_text(json.dumps(eval_metrics, indent=2))
    return result


def _save_error_panel(path: Path, outputs: dict, max_frames: int = 4) -> None:
    """Rendered / reference / |error| grid of the first frames (matplotlib;
    skipped with a warning when it is not installed)."""
    try:
        import matplotlib
    except ImportError:
        logging.getLogger(LOGGER).warning(
            "matplotlib is not installed: %s is not written", path.name)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(max_frames, outputs["rendered_masks"].shape[0])
    fig, axes = plt.subplots(3, n, figsize=(3 * n, 9), squeeze=False)
    for i in range(n):
        axes[0][i].imshow(outputs["rendered_masks"][i], cmap="gray")
        axes[0][i].set_title(f"rendered {i}")
        axes[1][i].imshow(outputs["ref_masks"][i], cmap="gray")
        axes[1][i].set_title(f"reference {i}")
        axes[2][i].imshow(outputs["error_maps"][i], cmap="hot")
        axes[2][i].set_title(f"|error| {i}")
        for r in range(3):
            axes[r][i].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=60)
    plt.close(fig)
