"""Iterative (online) calibration — capture → optimize → explore → move.

Torch counterpart of easyhec_tpu/trainer/iterative.py (the reference's
RBSolverIterTrainer): each round captures a frame at the current arm pose,
re-optimizes the camera-from-base pose over ALL frames so far, then picks
the next joint pose by consistency-based exploration and drives the arm
there through the host-side RRT planner.

Hardware is injected through the interfaces in easyhec_torch.io — by
default a fully simulated rig (SimArm + SimCamera with a hidden GT
extrinsic), so the whole loop runs closed-loop without a robot. Runs on
CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config.config import Config, save_config
from ..data.dataset import CalibBatch, save_calib_frame
from ..geometry import se3
from ..io.interfaces import Camera, MaskSource, RendererMaskSource, RobotArm, SimArm, SimCamera
from ..io.planner import plan_first_feasible
from ..models.calib import BinOverflowError, CalibResult, calibrate, downscale_K
from ..models.explorer import SpaceExplorer, build_link_spheres
from ..render.renderer import RobotRenderer
from ..robot import load_link_meshes, parse_urdf
from ..robot.mesh import decimate_vertex_clustering
from ..utils.checkpoint import save_checkpoint
from ..utils.logging import MetricsWriter, setup_logger
from ..utils.scene3d import Scene3D
from .offline import Runtime, _init_dof, build_runtime, escalate_render_budgets

__all__ = ["run_iterative"]


def _make_explorer(cfg: Config, rt: Runtime, spheres) -> tuple[SpaceExplorer, int]:
    """The explorer and its render downscale ds. Variance scoring runs at
    1/ds resolution (cfg.explorer.render_downscale) on LOD-matched meshes
    (decimated at explorer.decimate_voxel, or model.decimate_voxel · ds; 0 =
    not decimated) with 2x the model config's capacity-class budgets: those
    are audited for the model's resolution, and explored poses at 1/ds
    concentrate loads differently. SpaceExplorer still escalates 2x and
    re-scores if the headroom is ever exceeded."""
    ds = max(1, cfg.explorer.render_downscale)
    r = rt.renderer
    if ds > 1 and r.meshes:
        vox = cfg.explorer.decimate_voxel or cfg.model.decimate_voxel * ds
        emeshes = r.meshes
        if vox > 0:
            emeshes = [decimate_vertex_clustering(m, vox) for m in r.meshes]
        t = r.tile
        tile2 = t._replace(
            capacity=t.capacity * 2,
            bin_big_k=t.bin_big_k * 2 if t.bin_big_k else t.bin_big_k,
            compact_chunks=t.compact_chunks * 2 if t.compact_chunks else 0,
            bwd_chunks=t.bwd_chunks * 2 if t.bwd_chunks else 0,
        )
        er = RobotRenderer(emeshes, r.H // ds, r.W // ds, tile=tile2, mode=r.mode,
                           device=r.device)
    else:
        ds = 1
        er = r
    e = cfg.explorer
    explorer = SpaceExplorer(
        rt.chain, er, rt.link_names, spheres=spheres,
        n_sample_qposes=e.n_sample_qposes, n_hypotheses=e.n_hypotheses,
        history_start=e.history_start,
        max_dist=e.max_dist if e.max_dist_constraint else None,
    )
    return explorer, ds


def run_iterative(
    cfg: Config,
    arm: RobotArm | None = None,
    camera: Camera | None = None,
    mask_source: MaskSource | None = None,
    Tc_c2b_gt: np.ndarray | None = None,
    K: np.ndarray | None = None,
    device=None,
) -> CalibResult:
    """Run cfg.solver.explore_iters rounds of capture → calibrate → explore
    → plan-and-move on ``device`` (None means CUDA). Without an arm, camera
    or mask source the rig is simulated and needs Tc_c2b_gt and K. Writes
    the captures, round checkpoints, metrics and the solved pose under
    cfg.output_dir."""
    logger = setup_logger(cfg.output_dir)
    out = Path(cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_config(cfg, out / "config.yaml")
    writer = MetricsWriter(out)

    rt = build_runtime(cfg, device)
    chain = rt.chain

    if arm is None or camera is None or mask_source is None:
        # Fully simulated closed loop (no hardware): GT extrinsic hidden in
        # the camera.
        if Tc_c2b_gt is None or K is None:
            raise ValueError("simulated run needs Tc_c2b_gt and K")
        arm = arm or SimArm(chain.n_dof)
        camera = camera or SimCamera(rt.renderer, chain, rt.link_names, Tc_c2b_gt, K, arm)
        mask_source = mask_source or RendererMaskSource()

    spheres = None
    workspace_pts = None
    if cfg.explorer.self_collision_check:
        model = parse_urdf(cfg.model.urdf_path)
        mesh_map = load_link_meshes(model, link_names=rt.link_names)
        spheres = build_link_spheres(chain, mesh_map)
        if cfg.explorer.use_workspace_boundary:
            # Env obstacle cloud for the planner (the reference feeds the lab
            # workspace boundary to its planner, space_explorer.py:97-98).
            from ..io.workspace import workspace_boundary_points

            workspace_pts = workspace_boundary_points(table_z=cfg.explorer.workspace_table_z)

    explorer, explore_ds = _make_explorer(cfg, rt, spheres)

    # 3D debug recording per round, gated by cfg.dbg like the reference.
    viz = Scene3D(out, enable=cfg.dbg)
    link_idx_np = np.asarray([chain.link_index(n) for n in rt.link_names])

    data_dir = Path(cfg.dataset.data_dir or (out / "captures"))
    masks, qposes = [], []
    result: CalibResult | None = None
    dof = None
    K_live = None

    for it in range(cfg.solver.explore_iters):
        t0 = time.time()
        q = arm.get_qpos()
        rgb, K_live = camera.capture()
        # Adapt render geometry to the live frame (the reference overwrites
        # H/W/K from the first capture): rebuild the renderer at the captured
        # resolution rather than corrupt the loss.
        cap_h, cap_w = rgb.shape[:2]
        if (cap_h, cap_w) != (rt.renderer.H, rt.renderer.W):
            if masks:
                raise RuntimeError(
                    f"camera resolution changed mid-run: captured {cap_h}x{cap_w}, "
                    f"dataset is {masks[0].shape[0]}x{masks[0].shape[1]}"
                )
            logger.warning("captured frame %dx%d != configured %dx%d; rebuilding "
                           "renderer at the live resolution",
                           cap_h, cap_w, rt.renderer.H, rt.renderer.W)
            cfg.model.H, cfg.model.W = int(cap_h), int(cap_w)
            rt = build_runtime(cfg, device)
            explorer, explore_ds = _make_explorer(cfg, rt, spheres)
        mask = mask_source.predict(rgb)
        save_calib_frame(data_dir, it, rgb, mask, q)
        masks.append(mask)
        qposes.append(q)
        np.savetxt(data_dir / "K.txt", K_live)

        link_idx = [chain.link_index(n) for n in rt.link_names]
        link_poses = np.stack([chain.fk_np(qq) for qq in qposes])[:, link_idx]

        if dof is None:
            batch_stub = CalibBatch(
                rgb=np.zeros((1, 1, 1, 3), np.uint8),
                masks=np.asarray(masks),
                qpos=np.asarray(qposes),
                link_poses=link_poses.astype(np.float32),
                K=np.asarray(K_live, np.float32),
                Tc_c2b_gt=np.eye(4, dtype=np.float32),
            )
            dof = _init_dof(cfg, batch_stub, rt)

        # Overflow is checked at every rebin; explored poses maximize render
        # disagreement and can concentrate loads beyond any random-pose
        # audit, so on overflow the budgets double and the round restarts.
        t_cal = time.time()
        for attempt in range(3):
            try:
                result = calibrate(
                    dof, rt.renderer, link_poses.astype(np.float32),
                    np.asarray(K_live, np.float32), np.stack(masks).astype(np.float32),
                    num_steps=cfg.solver.num_epochs, max_lr=cfg.solver.max_lr,
                    optimizer=cfg.solver.optimizer, scheduler=cfg.solver.scheduler,
                    grad_clip=cfg.solver.grad_clip, sharpness=cfg.render.sharpness,
                    robust_delta=cfg.solver.robust_delta,
                    rebin_every=cfg.solver.rebin_every, Tc_c2b_gt=Tc_c2b_gt,
                )
                break
            except BinOverflowError as e:
                if attempt == 2:
                    raise
                escalate_render_budgets(cfg)
                logger.warning("%s — escalating to capacity=%d compact_chunks=%d and "
                               "rebuilding", e, cfg.render.capacity,
                               cfg.render.compact_chunks)
                rt = build_runtime(cfg, device)
                explorer, explore_ds = _make_explorer(cfg, rt, spheres)
        t_cal = time.time() - t_cal
        dof = result.dof  # warm start the next round
        writer.scalars(
            it,
            round_loss=float(result.losses[-1]),
            n_frames=len(masks),
            **{f"round_{k}": v for k, v in result.metrics.items()},
        )
        save_checkpoint(
            out / "checkpoints" / f"round_{it:03d}",
            {"dof": result.dof, "history": result.history, "losses": result.losses},
            meta={"round": it, "n_frames": len(masks)},
        )

        t_exp = time.time()
        if it == cfg.solver.explore_iters - 1:
            target = np.zeros(chain.n_dof, np.float32)  # reference to_zero mode
            plan_candidates = [target]
        else:
            K_explore = downscale_K(np.asarray(K_live), explore_ds) if explore_ds > 1 \
                else K_live
            res = explorer.explore(result.history, K_explore, key=it)
            logger.info("explore %d: variance %.2f, %d/%d feasible (%s, spread %.2f px)",
                        it, res.variance, int(res.feasible.sum()), len(res.feasible),
                        "shared" if explorer.last_shared else "exact",
                        explorer.last_spread_px)
            # Plan-feasibility gate: plan the top-k by variance until one
            # succeeds (the reference scores only candidates it can plan to).
            order = np.argsort(-res.var_all)
            top = [res.qpos_all[i] for i in order[: max(1, cfg.explorer.plan_top_k)]
                   if np.isfinite(res.var_all[i])]
            target = res.qpos
            plan_candidates = top or [res.qpos]
        t_exp = time.time() - t_exp
        if cfg.dbg:
            viz.set_scene_id(it)
            viz.add_image(rgb, name="capture")
            viz.add_image(mask, name="mask")
            Tc = se3.exp(torch.as_tensor(np.asarray(dof), dtype=torch.float32)).numpy()
            viz.add_camera(Tc, K=K_live, name="solved_camera")
            viz.add_robot(chain, rt.renderer, link_idx_np, np.eye(4), q, name="robot_current")
            viz.add_robot(chain, rt.renderer, link_idx_np, np.eye(4), target,
                          name="robot_proposed")

        t_plan = time.time()
        if spheres is None:
            # Planning disabled by config (e.g. pure-sim smoke runs): direct
            # joint move, the caller opted out of collision safety.
            arm.move_to(target, None)
        else:
            # Plan-or-skip: an unplannable pose is never commanded.
            env_pts = workspace_pts if cfg.explorer.use_workspace_boundary else None
            chosen, plan = plan_first_feasible(chain, spheres, q, plan_candidates,
                                               env_points=env_pts, seed=it)
            if chosen is not None:
                target = chosen
                arm.move_to(target, plan)
            else:
                logger.warning("no plannable candidate among top %d; staying at current "
                               "qpos this round", len(plan_candidates))
        t_plan = time.time() - t_plan
        logger.info(
            "round %d: %d frames, loss %.4f -> %.4f (%.1fs: calibrate %.1fs, explore "
            "%.1fs, plan %.1fs)%s",
            it, len(masks), result.losses[0], result.losses[-1], time.time() - t0,
            t_cal, t_exp, t_plan,
            f" metrics={json.dumps(result.metrics)}" if result.metrics else "",
        )

    np.savetxt(out / "Tc_c2b.txt", result.Tc_c2b)
    (out / "metrics.json").write_text(json.dumps(result.metrics, indent=2))
    writer.close()
    return result
