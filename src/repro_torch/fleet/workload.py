"""Service models and multi-class workloads: per-replica request-serving
behaviour derived from the scoping engine, plus the request classes a fleet
serves.

A replica is one container of a given ``CloudShape`` running the workload. Its
batch service time comes straight from a scoping ``CellResult`` via
``CellResult.service_terms`` — fixed (weight-streaming / collective) seconds plus
per-request compute seconds — so batching amortizes ``t_step`` exactly as the
roofline predicts.

A production fleet rarely serves one request stream: interactive traffic with a
sub-second SLO shares capacity with batch backfill that can wait half a minute.
``RequestClass`` names one such stream (its SLO doubles as its EDF relative
deadline); ``Workload`` bundles per-class arrival traces into the multi-class
input the simulator and scheduling disciplines consume.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from repro_torch.core.catalog import CloudShape, get_shape
from repro_torch.core.scoping import CellResult
from repro_torch.fleet.traces import Trace


@dataclass(frozen=True)
class ServiceModel:
    """One replica's queueing behaviour: serving b requests takes
    ``t_fixed + b * t_per_unit`` seconds, up to ``max_batch`` per batch."""
    name: str
    shape: CloudShape
    t_fixed: float
    t_per_unit: float
    max_batch: int

    def batch_time(self, b) -> np.ndarray:
        """Seconds to serve a batch of b requests (scalar or array)."""
        return self.t_fixed + np.asarray(b, float) * self.t_per_unit

    def throughput(self, b) -> np.ndarray:
        """Requests/s of one replica running back-to-back batches of size b."""
        b = np.asarray(b, float)
        return b / np.maximum(self.batch_time(b), 1e-12)

    @cached_property
    def max_throughput(self) -> float:
        """Requests/s at full batch — the replica's capacity (cached: the
        simulator and policies read this every bin)."""
        return float(self.throughput(self.max_batch))

    @property
    def usd_per_replica_hour(self) -> float:
        return self.shape.price_per_hour

    @property
    def usd_per_request(self) -> float:
        """Dollars per request at full batch — the cost-efficiency key a
        heterogeneous fleet drains its shared queue by."""
        return self.shape.price_per_hour / max(self.max_throughput * 3600.0,
                                               1e-12)


@dataclass(frozen=True)
class RequestClass:
    """One request class in a multi-class workload.

    ``slo_s`` is the per-request latency SLO and doubles as the class's
    relative deadline under EDF; ``priority`` orders classes under strict
    priority (lower = more critical, FIFO within a class)."""
    name: str
    slo_s: float
    priority: int = 0

    def __post_init__(self):
        if not np.isfinite(self.slo_s) or self.slo_s <= 0:
            raise ValueError(f"class {self.name!r}: slo_s must be a positive "
                             f"finite number, got {self.slo_s}")


@dataclass(frozen=True)
class Workload:
    """Multi-class workload: one arrival ``Trace`` per ``RequestClass``, all
    aligned on the same bins and Monte Carlo seeds."""
    name: str
    classes: tuple          # RequestClass per class
    traces: tuple           # Trace per class, aligned (dt, bins, seeds)

    def __post_init__(self):
        object.__setattr__(self, "classes", tuple(self.classes))
        object.__setattr__(self, "traces", tuple(self.traces))
        if not self.classes or len(self.classes) != len(self.traces):
            raise ValueError("Workload needs one trace per class "
                             f"({len(self.classes)} classes, "
                             f"{len(self.traces)} traces)")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names: {names}")
        ref = self.traces[0]
        for tr in self.traces[1:]:
            if (tr.dt_s != ref.dt_s or tr.n_bins != ref.n_bins
                    or tr.n_seeds != ref.n_seeds):
                raise ValueError(
                    "class traces must share dt/bins/seeds: "
                    f"({ref.dt_s}, {ref.n_bins}, {ref.n_seeds}) vs "
                    f"({tr.dt_s}, {tr.n_bins}, {tr.n_seeds})")

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def dt_s(self) -> float:
        return self.traces[0].dt_s

    @property
    def n_bins(self) -> int:
        return self.traces[0].n_bins

    @property
    def n_seeds(self) -> int:
        return self.traces[0].n_seeds

    @property
    def duration_s(self) -> float:
        return self.traces[0].duration_s

    @property
    def arrivals(self) -> np.ndarray:
        """(n_seeds, n_bins, n_classes) sampled request counts."""
        return np.stack([tr.arrivals for tr in self.traces], axis=2)

    def slos(self) -> np.ndarray:
        return np.array([c.slo_s for c in self.classes], float)

    def total_trace(self) -> Trace:
        """The aggregate arrival stream (for aggregate reporting)."""
        return Trace(name=self.name, dt_s=self.dt_s,
                     rate=np.sum([tr.rate for tr in self.traces], axis=0),
                     arrivals=np.sum([tr.arrivals for tr in self.traces],
                                     axis=0))

    @staticmethod
    def from_trace(trace: Trace, slo_s: float, name: str = None,
                   class_name: str = "default") -> "Workload":
        """Wrap a single-class trace (the pre-multi-class simulator input)."""
        return Workload(name or trace.name,
                        (RequestClass(class_name, slo_s),), (trace,))


def service_model_from_cell(cell: CellResult, units_per_step: float,
                            max_batch: int = None, name: str = None,
                            shape: CloudShape = None) -> ServiceModel:
    """Build a ServiceModel from one scoping row.

    ``units_per_step`` is how many requests the scoped step batched (the cell's
    batch dimension); ``max_batch`` defaults to it.
    """
    t_fixed, t_unit = cell.service_terms(units_per_step)
    shape = shape if shape is not None else get_shape(cell.shape_name)
    mb = int(max_batch if max_batch is not None else units_per_step)
    return ServiceModel(
        name=name or f"{cell.shape_name}",
        shape=shape,
        t_fixed=float(t_fixed),
        t_per_unit=float(max(t_unit, 1e-12)),
        max_batch=max(mb, 1),
    )
