"""Post-fit evaluators.

The reference has a registry-driven evaluator hook (`build_evaluators`
iterating cfg.test.evaluators, easyhec/evaluators/build.py:5-9) but registers
no concrete evaluator in the snapshot (SURVEY.md §2). Here the hook exists
AND ships two real evaluators used by the CLI after calibration:

- MaskIoUEvaluator: IoU / precision / recall of rendered vs reference masks.
- PoseErrorEvaluator: the reference's err_x/y/z/trans/rot metrics
  (easyhec/modeling/models/rb_solve/rb_solver.py:82-91) plus proper geodesic
  distances.
"""
from __future__ import annotations

import numpy as np

from ..registry import EVALUATORS

__all__ = ["build_evaluators", "MaskIoUEvaluator", "PoseErrorEvaluator"]


@EVALUATORS.register("mask_iou")
class MaskIoUEvaluator:
    """outputs: dict with rendered_masks [B,H,W] and ref_masks [B,H,W]."""

    threshold: float = 0.5

    def __call__(self, outputs: dict, batch=None) -> dict[str, float]:
        pred = np.asarray(outputs["rendered_masks"]) > self.threshold
        ref = np.asarray(outputs["ref_masks"]) > self.threshold
        inter = (pred & ref).sum((-2, -1)).astype(np.float64)
        union = (pred | ref).sum((-2, -1)).astype(np.float64)
        p_sum = pred.sum((-2, -1)).astype(np.float64)
        r_sum = ref.sum((-2, -1)).astype(np.float64)
        iou = inter / np.maximum(union, 1)
        precision = inter / np.maximum(p_sum, 1)
        recall = inter / np.maximum(r_sum, 1)
        return {
            "mask_iou": float(iou.mean()),
            "mask_iou_min": float(iou.min()),
            "mask_precision": float(precision.mean()),
            "mask_recall": float(recall.mean()),
        }


@EVALUATORS.register("pose_error")
class PoseErrorEvaluator:
    """outputs: dict with dof [6]; batch must carry Tc_c2b_gt."""

    def __call__(self, outputs: dict, batch=None) -> dict[str, float]:
        gt = getattr(batch, "Tc_c2b_gt", None) if batch is not None else None
        if gt is None or np.allclose(gt, np.eye(4)):
            return {}
        from ..models.calib import pose_metrics

        return pose_metrics(np.asarray(outputs["dof"]), np.asarray(gt))


def build_evaluators(names: list[str]):
    """Registry lookup, one instance per name (reference
    easyhec/evaluators/build.py:5-9)."""
    return [EVALUATORS.build(n) for n in names]
