from .iterative import run_iterative
from .offline import build_runtime, run_offline_calibration

__all__ = ["build_runtime", "run_iterative", "run_offline_calibration"]
