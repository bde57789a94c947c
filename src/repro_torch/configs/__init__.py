# Only the MSET2 use case so far; the LM architecture registry comes with the LM side.
from repro_torch.configs.mset_paper import (
    CUSTOMER_A,
    CUSTOMER_B,
    SURVEILLANCE_GRID_64,
    SURVEILLANCE_GRID_1024,
    TRAINING_GRID,
    MSETUseCase,
)

__all__ = [
    "MSETUseCase",
    "TRAINING_GRID",
    "SURVEILLANCE_GRID_64",
    "SURVEILLANCE_GRID_1024",
    "CUSTOMER_A",
    "CUSTOMER_B",
]
