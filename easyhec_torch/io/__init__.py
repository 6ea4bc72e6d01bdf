from .interfaces import (
    Camera,
    FrankaROSAdapter,
    MaskSource,
    PrecomputedMaskSource,
    RealSenseAdapter,
    RendererMaskSource,
    RobotArm,
    SimArm,
    SimCamera,
    XArmAdapter,
)
from .planner import (
    CollisionModel,
    RRTPlanner,
    plan_first_feasible,
    plan_to_qpos,
    time_parameterize,
)

__all__ = [
    "Camera", "MaskSource", "PrecomputedMaskSource", "RealSenseAdapter",
    "RendererMaskSource", "RobotArm", "SimArm", "SimCamera", "XArmAdapter",
    "FrankaROSAdapter", "CollisionModel", "RRTPlanner", "plan_first_feasible",
    "plan_to_qpos", "time_parameterize",
]
