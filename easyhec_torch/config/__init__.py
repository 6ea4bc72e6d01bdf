from .config import (
    Config,
    DatasetConfig,
    ExplorerConfig,
    ModelConfig,
    RenderConfig,
    SolverConfig,
    apply_overrides,
    load_config,
    save_config,
)

__all__ = [
    "Config", "DatasetConfig", "ExplorerConfig", "ModelConfig", "RenderConfig",
    "SolverConfig", "apply_overrides", "load_config", "save_config",
]
