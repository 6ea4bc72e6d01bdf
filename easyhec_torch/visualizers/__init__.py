from .visualizers import ErrorMaskVisualizer, HoverMaskVisualizer, build_visualizer

__all__ = ["build_visualizer", "HoverMaskVisualizer", "ErrorMaskVisualizer"]
