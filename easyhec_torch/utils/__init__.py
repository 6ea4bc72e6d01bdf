from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .live import write_dashboard
from .logging import MetricsWriter, setup_logger

__all__ = [
    "latest_checkpoint", "load_checkpoint", "save_checkpoint",
    "MetricsWriter", "setup_logger", "write_dashboard",
]
