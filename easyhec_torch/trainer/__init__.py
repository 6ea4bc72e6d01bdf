from .offline import build_runtime, run_offline_calibration

__all__ = ["build_runtime", "run_offline_calibration"]
