from .evaluators import MaskIoUEvaluator, PoseErrorEvaluator, build_evaluators

__all__ = ["build_evaluators", "MaskIoUEvaluator", "PoseErrorEvaluator"]
