from repro_torch.configs.base import (
    ModelConfig,
    ShapeSpec,
    SHAPES,
    ARCH_REGISTRY,
    get_config,
    list_archs,
    runnable_cells,
    cell_skip_reason,
)

__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_REGISTRY",
    "get_config",
    "list_archs",
    "runnable_cells",
    "cell_skip_reason",
]
