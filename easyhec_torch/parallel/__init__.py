"""Multi-rank calibration over torch.distributed (counterpart of
easyhec_tpu/parallel): process-group set-up, host-side communication and
the ("data", "tile") mesh's sharded render, loss and calibrate."""
from .distributed import init_distributed, maybe_init_from_env
from .sharding import (
    make_mesh,
    pad_frames,
    sharded_calibrate,
    sharded_mask_loss,
    sharded_silhouette,
)

__all__ = [
    "make_mesh", "pad_frames", "sharded_calibrate", "sharded_mask_loss",
    "sharded_silhouette", "init_distributed", "maybe_init_from_env",
]
