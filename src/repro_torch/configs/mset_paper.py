"""The paper's own use case: MSET2 prognostic surveillance as a cloud service.

The three "conventional ML design parameters" (paper §I):
  n_signals      — sensors per asset
  n_observations — training observations (sampling rate × window)
  n_memvec       — memory vectors retained in the MSET2 memory matrix D

``PAPER_GRID`` mirrors the sweep ranges of Figures 4-8 (powers of two, with the
MSET constraint n_memvec >= 2 * n_signals).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class MSETUseCase:
    name: str
    n_signals: int
    n_observations: int
    n_memvec: int

    def valid(self) -> bool:
        # Paper: "the number of memory vectors is at least twice the number of
        # signals required by MSET2" (Fig. 6 caption).
        return self.n_memvec >= 2 * self.n_signals


# Figure 6 axes: signals 2^5..2^10, memvec 2^7..2^13
TRAINING_GRID = {
    "n_signals": [2**k for k in range(5, 11)],
    "n_memvec": [2**k for k in range(7, 14)],
    "n_observations": [4096],
}

# Figures 7/8 axes: observations x memvec at fixed 64 / 1024 signals
SURVEILLANCE_GRID_64 = {
    "n_signals": [64],
    "n_memvec": [2**k for k in range(7, 14)],
    "n_observations": [2**k for k in range(10, 17)],
}
SURVEILLANCE_GRID_1024 = {
    "n_signals": [1024],
    "n_memvec": [2**k for k in range(11, 14)],
    "n_observations": [2**k for k in range(10, 17)],
}

# Customer archetypes from §I of the paper.
CUSTOMER_A = MSETUseCase("customer-A-small", n_signals=20, n_observations=8760, n_memvec=128)
CUSTOMER_B = MSETUseCase("customer-B-airbus-fleet", n_signals=75_000,
                         n_observations=2_592_000, n_memvec=8192)
