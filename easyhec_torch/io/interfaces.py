"""Pluggable hardware/perception interfaces + simulated implementations.

Torch counterpart of easyhec_tpu/io/interfaces.py: the same protocols,
simulated rig and hardware adapters; SimCamera renders on its renderer's
device.

The reference hardwires three side-channels into its trainer (SURVEY.md L5):
the xArm TCP SDK / Franka MoveIt node (trainer/rbsolve_iter.py:52-63),
a RealSense capture pipeline (utils/realsense_api.py), and mask prediction
via PointRend or an interactive SAM UI (utils/pointrend_api.py,
utils/prompt_drawer.py). Here each is a small interface with:

- simulated implementations (closed-loop testing without hardware — the
  capability the reference only approximated with its SAPIEN scripts), and
- thin adapters for the real devices, gated on their SDKs being importable.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol

import numpy as np
import torch

__all__ = [
    "RobotArm",
    "Camera",
    "MaskSource",
    "SimArm",
    "SimCamera",
    "RendererMaskSource",
    "PrecomputedMaskSource",
    "XArmAdapter",
    "RealSenseAdapter",
    "FrankaROSAdapter",
]


class RobotArm(Protocol):
    def get_qpos(self) -> np.ndarray: ...

    def move_to(self, qpos: np.ndarray, plan: dict | None = None) -> None:
        """Drive to a joint configuration (optionally along a timed plan)."""

    def reset(self) -> None: ...


class Camera(Protocol):
    def capture(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (rgb [H, W, 3] uint8, K [3, 3])."""


class MaskSource(Protocol):
    def predict(self, rgb: np.ndarray) -> np.ndarray:
        """-> mask [H, W] float in {0, 1}."""


# ---------------------------------------------------------------- simulated


@dataclass
class SimArm:
    """Perfect simulated arm: instantly reaches targets."""

    n_dof: int
    qpos: np.ndarray | None = None
    trajectory_log: list = field(default_factory=list)

    def __post_init__(self):
        if self.qpos is None:
            self.qpos = np.zeros(self.n_dof, np.float32)

    def get_qpos(self) -> np.ndarray:
        return np.asarray(self.qpos, np.float32).copy()

    def move_to(self, qpos: np.ndarray, plan: dict | None = None) -> None:
        self.trajectory_log.append(np.asarray(qpos).copy())
        self.qpos = np.asarray(qpos, np.float32).copy()

    def reset(self) -> None:
        self.qpos = np.zeros(self.n_dof, np.float32)


class SimCamera:
    """Camera that renders the simulated scene with the framework's own
    renderer at a fixed (hidden) GT extrinsic — the closed-loop test rig.
    Renders on the renderer's device."""

    def __init__(self, renderer, chain, link_names, Tc_c2b_gt, K, arm: SimArm):
        dev = renderer.device
        self._renderer = renderer
        self._chain = chain
        self._link_idx = torch.as_tensor([chain.link_index(n) for n in link_names],
                                         device=dev)
        self._Tc = torch.tensor(np.asarray(Tc_c2b_gt), dtype=torch.float32, device=dev)
        self._K = np.asarray(K, np.float32)
        self._K_dev = torch.tensor(self._K, device=dev)
        self._arm = arm

    @torch.no_grad()
    def _render(self, q: np.ndarray) -> np.ndarray:
        q_dev = torch.as_tensor(np.asarray(q), dtype=torch.float32,
                                device=self._renderer.device)
        lp = self._chain.fk(q_dev)[self._link_idx]
        return self._renderer.silhouette(self._Tc, lp, self._K_dev).cpu().numpy()

    def capture(self) -> tuple[np.ndarray, np.ndarray]:
        mask = self._render(self._arm.get_qpos())
        rgb = (np.repeat(mask[..., None], 3, -1) * 255).astype(np.uint8)
        return rgb, self._K.copy()


class RendererMaskSource:
    """Mask source for SimCamera captures (mask == image intensity)."""

    def predict(self, rgb: np.ndarray) -> np.ndarray:
        return (rgb[..., 0] > 127).astype(np.float32)


@dataclass
class PrecomputedMaskSource:
    """Masks already on disk (the reference's offline mode)."""

    masks: np.ndarray  # [B, H, W]
    _cursor: int = 0

    def predict(self, rgb: np.ndarray) -> np.ndarray:
        m = self.masks[self._cursor % len(self.masks)]
        self._cursor += 1
        return np.asarray(m, np.float32)


# ---------------------------------------------------------------- real HW


class XArmAdapter:
    """UFactory xArm over TCP (thin port of the reference's usage:
    trainer/rbsolve_iter.py:52-59,191-217,239). Requires the xArm SDK."""

    def __init__(self, ip: str, speed: float = 0.1, safety_factor: float = 6.0):
        try:
            from xarm.wrapper import XArmAPI  # type: ignore
        except ImportError as e:  # pragma: no cover - HW only
            raise RuntimeError("xArm-Python-SDK not installed") from e
        self._arm = XArmAPI(ip)
        self._arm.motion_enable(enable=True)
        self._arm.set_mode(0)
        self._arm.set_state(state=0)
        self.speed = speed
        self.safety_factor = safety_factor

    def get_qpos(self) -> np.ndarray:  # pragma: no cover - HW only
        code, angles = self._arm.get_servo_angle(is_radian=True)
        return np.asarray(angles, np.float32)

    def move_to(self, qpos, plan=None) -> None:  # pragma: no cover - HW only
        if plan is not None and plan.get("status") == "Success":
            # velocity control along the timed plan, clipped for safety
            self._arm.set_mode(4)
            self._arm.set_state(0)
            time.sleep(0.1)
            dt = float(plan["time"][1] - plan["time"][0]) if len(plan["time"]) > 1 else 0.05
            for v in plan["velocity"]:
                v = np.clip(v / self.safety_factor, -0.3, 0.3)
                self._arm.vc_set_joint_velocity(list(v), is_radian=True)
                time.sleep(dt)
            self._arm.vc_set_joint_velocity([0.0] * len(qpos), is_radian=True)
            self._arm.set_mode(0)
            self._arm.set_state(0)
        else:
            self._arm.set_servo_angle(
                angle=list(np.asarray(qpos, float)), is_radian=True,
                speed=self.speed, wait=True,
            )

    def reset(self) -> None:  # pragma: no cover - HW only
        self.move_to(np.zeros(7))


class RealSenseAdapter:
    """Intel RealSense capture (reference utils/realsense_api.py:8-69)."""

    def __init__(self, width: int = 1280, height: int = 720, warmup: int = 10):
        try:
            import pyrealsense2 as rs  # type: ignore
        except ImportError as e:  # pragma: no cover - HW only
            raise RuntimeError("pyrealsense2 not installed") from e
        self._rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, width, height, rs.format.rgb8, 30)
        self.profile = self.pipeline.start(cfg)
        for _ in range(warmup):  # pragma: no cover - HW only
            self.pipeline.wait_for_frames()

    def capture(self):  # pragma: no cover - HW only
        frames = self.pipeline.wait_for_frames()
        color = frames.get_color_frame()
        rgb = np.asanyarray(color.get_data())
        intr = color.profile.as_video_stream_profile().intrinsics
        K = np.array(
            [[intr.fx, 0, intr.ppx], [0, intr.fy, intr.ppy], [0, 0, 1]], np.float32
        )
        return rgb, K


class FrankaROSAdapter:
    """Franka arm over ROS/MoveIt (reference frankaAPI/franka.py:59-316:
    MoveGroupPythonInterfaceTutorial with go_to_rest_pose / set_servo_angle /
    get_servo_angle). Requires a running ROS master + moveit_commander;
    import is deferred so the framework stays usable without ROS.
    """

    REST_QPOS = np.array(
        [0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785], np.float32
    )

    def __init__(self, group_name: str = "panda_arm", velocity_scale: float = 0.15):
        try:  # pragma: no cover - HW/ROS only
            import moveit_commander  # type: ignore
            import rospy  # type: ignore
        except ImportError as e:
            raise RuntimeError("moveit_commander/rospy not installed") from e
        import sys as _sys

        moveit_commander.roscpp_initialize(_sys.argv)
        if not rospy.core.is_initialized():  # pragma: no cover
            rospy.init_node("easyhec_torch_franka", anonymous=True)
        self._rospy = rospy
        self.robot = moveit_commander.RobotCommander()
        self.group = moveit_commander.MoveGroupCommander(group_name)
        self.group.set_max_velocity_scaling_factor(velocity_scale)

    def get_qpos(self) -> np.ndarray:  # pragma: no cover - HW only
        return np.asarray(self.group.get_current_joint_values(), np.float32)

    def move_to(self, qpos, plan=None) -> None:  # pragma: no cover - HW only
        # MoveIt owns trajectory timing; the precomputed plan is advisory
        # here (the reference's franka path also delegates to MoveIt,
        # trainer/rbsolve_iter.py:60-63).
        self.group.go(list(np.asarray(qpos, float)), wait=True)
        self.group.stop()

    def reset(self) -> None:  # pragma: no cover - HW only
        self.move_to(self.REST_QPOS)
