"""Roofline + dollar cost model (the 'compute cost' axis of the paper's response
surfaces), priced for TPU v5e shapes and NVIDIA H100 nodes.

v5e constants per the brief: 197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s/link ICI.
H100 constants from NVIDIA's H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s
HBM3, 80 GB, NVLink 900 GB/s all to all (450 GB/s each way).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # B/s per chip
    ici_bw: float = 50e9  # B/s per ICI link (NVLink: per direction)
    hbm_per_chip: float = 16 * 2**30  # bytes
    price_per_chip_hour: float = 1.20  # USD (public on-demand v5e)


V5E = HardwareSpec()

# Assumption, not a measurement: AWS's on-demand list price for p5.48xlarge
# (8x H100 SXM, us-east-1) of USD 98.32 per hour, divided over its 8 GPUs.
H100_USD_PER_GPU_HOUR = 98.32 / 8

H100 = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_per_chip=80e9,
    price_per_chip_hour=H100_USD_PER_GPU_HOUR,
)


@dataclass
class RooflineTerms:
    """All terms in seconds-per-step for the whole job (global work / aggregate
    capability)."""

    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """Ideal-overlap step time (the roofline bound)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        """No-overlap upper bound."""
        return self.t_compute + self.t_memory + self.t_collective

    def as_dict(self) -> dict:
        return {
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "t_step": self.t_step,
            "dominant": self.dominant,
        }


def roofline(
    flops_global: float,
    bytes_global: float,
    coll_bytes_global: float,
    chips: int,
    hw: HardwareSpec = V5E,
) -> RooflineTerms:
    return RooflineTerms(
        t_compute=flops_global / (chips * hw.peak_flops),
        t_memory=bytes_global / (chips * hw.hbm_bw),
        t_collective=coll_bytes_global / (chips * hw.ici_bw),
    )


def dollar_cost(step_time_s: float, n_steps: float, chips: int, hw: HardwareSpec = V5E) -> float:
    hours = step_time_s * n_steps / 3600.0
    return hours * chips * hw.price_per_chip_hour


def mfu(model_flops: float, step_time_s: float, chips: int, hw: HardwareSpec = V5E) -> float:
    """Model FLOPs utilization against aggregate peak."""
    if step_time_s <= 0:
        return 0.0
    return model_flops / (step_time_s * chips * hw.peak_flops)
