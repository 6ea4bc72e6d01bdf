from .arrays import min_max, norm, padded_stack, ptp, random_choice, to_array
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .imaging import hover_masks_on_imgs, image_grid, save_image, vis_mask
from .live import serve, write_dashboard
from .logging import MetricsWriter, setup_logger
from .runfiles import archive_runs, deterministic_seed, make_source_snapshot

__all__ = [
    "latest_checkpoint", "load_checkpoint", "save_checkpoint",
    "MetricsWriter", "setup_logger", "write_dashboard", "serve",
    "to_array", "min_max", "ptp", "norm", "random_choice", "padded_stack",
    "image_grid", "vis_mask", "hover_masks_on_imgs", "save_image",
    "archive_runs", "make_source_snapshot", "deterministic_seed",
]
