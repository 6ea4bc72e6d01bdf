from .batching import (
    ImageSizeBatchSampler,
    IterationBasedBatchSampler,
    OrderedShardSampler,
    default_collate,
    padded_collate,
)
from .dataset import CalibBatch, load_calib_dataset, save_calib_dataset, save_calib_frame
from .synthetic import default_camera, generate_dataset, generate_pose_dataset, sample_qposes
from .transforms import Compose, build_transforms

__all__ = [
    "CalibBatch", "load_calib_dataset", "save_calib_dataset", "save_calib_frame",
    "default_camera", "generate_dataset", "generate_pose_dataset", "sample_qposes",
    "default_collate", "padded_collate",
    "IterationBasedBatchSampler", "ImageSizeBatchSampler", "OrderedShardSampler",
    "Compose", "build_transforms",
]
