from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    input_specs,
    model_flops,
    shape_applicable,
)
from repro_torch.configs.mset_paper import (
    CUSTOMER_A,
    CUSTOMER_B,
    SURVEILLANCE_GRID_64,
    SURVEILLANCE_GRID_1024,
    TRAINING_GRID,
    MSETUseCase,
)
from repro_torch.configs.registry import ARCH_IDS, all_cells, get_config

__all__ = [
    "ArchConfig",
    "SHAPES",
    "ShapeSpec",
    "input_specs",
    "model_flops",
    "shape_applicable",
    "ARCH_IDS",
    "all_cells",
    "get_config",
    "MSETUseCase",
    "TRAINING_GRID",
    "SURVEILLANCE_GRID_64",
    "SURVEILLANCE_GRID_1024",
    "CUSTOMER_A",
    "CUSTOMER_B",
]
