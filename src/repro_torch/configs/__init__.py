from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeSpec, SHAPES, get_config, list_archs, cell_is_runnable,
)
