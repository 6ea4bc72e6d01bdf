from .calib import CalibResult, calibrate, mask_loss, pose_metrics, render_outputs
from .explorer import ExploreResult, LinkSpheres, SpaceExplorer, build_link_spheres

__all__ = ["CalibResult", "calibrate", "mask_loss", "pose_metrics", "render_outputs"]
