from . import camera, se3, so3
from .se3 import (
    from_rt,
    inverse,
    matrix_3x4_to_4x4,
    transform_points,
)

se3_exp = se3.exp
se3_log = se3.log
so3_exp = so3.exp
so3_log = so3.log

__all__ = [
    "camera",
    "se3",
    "so3",
    "se3_exp",
    "se3_log",
    "so3_exp",
    "so3_log",
    "from_rt",
    "inverse",
    "matrix_3x4_to_4x4",
    "transform_points",
]
