from .renderer import RobotRenderer
from .tiled import TileConfig

__all__ = ["RobotRenderer", "TileConfig"]
