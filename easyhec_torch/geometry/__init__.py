from . import camera, se3, so3

__all__ = ["camera", "se3", "so3"]
