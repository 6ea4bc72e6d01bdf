from .projection import Triangles2D, setup_triangles, transform_verts
from .raster_jnp import depth_bruteforce, silhouette_bruteforce
from .renderer import RobotRenderer
from .tiled import TileConfig, bin_triangles, depth_tiled, silhouette_tiled

__all__ = [
    "Triangles2D",
    "setup_triangles",
    "transform_verts",
    "depth_bruteforce",
    "silhouette_bruteforce",
    "RobotRenderer",
    "TileConfig",
    "bin_triangles",
    "depth_tiled",
    "silhouette_tiled",
]
