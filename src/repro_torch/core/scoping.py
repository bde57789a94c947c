"""ContainerStress — the paper's autonomous scoping engine.

Nested-loop Monte Carlo simulation over the ML design parameters (paper Fig. 1):
for every grid cell, the workload is instantiated and its compute cost measured;
results feed the response surfaces (surfaces.py) and the recommender.

Two cost probes:

* ``run_measured`` — wall-clock of the workload on the device its tensors live on,
  repeated over Monte Carlo draws (TPSS-synthesized inputs). This is the paper's
  own methodology (it timed CPU/GPU containers).
* ``run_analytic`` — the workload's step run once on meta tensors and counted op by
  op (``hlo_analysis.analyze``), then the three-term roofline cost for a catalog
  CloudShape (no hardware needed). One chip so far: shapes of more chips wait for
  the port's ``distributed/``.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch._device import sync
from repro_torch.core.catalog import CloudShape
from repro_torch.core.cost_model import H100, HardwareSpec, RooflineTerms, dollar_cost, roofline
from repro_torch.core.hlo_analysis import analyze


@dataclass
class CellResult:
    params: dict
    mean_s: float = float("nan")  # measured seconds per call
    std_s: float = float("nan")
    reps: int = 0
    shape_name: Optional[str] = None
    terms: Optional[RooflineTerms] = None
    analysis: Optional[dict] = None
    usd_per_1k_steps: Optional[float] = None

    def cost(self) -> float:
        """Scalar compute cost for surface fitting (seconds)."""
        if self.terms is not None:
            return self.terms.t_step
        return self.mean_s

    def service_terms(self, units_per_step: float = 1.0) -> tuple:
        """Split this cell's per-step cost into ``(t_fixed, t_per_unit)`` seconds
        for queueing models: serving a batch of b units takes
        ``t_fixed + b * t_per_unit``.

        With roofline terms, weight-streaming (memory) and collective traffic are
        batch-independent while compute scales with the batch; measured cells have
        no decomposition, so the whole cost amortizes linearly.
        """
        if units_per_step <= 0:
            raise ValueError(f"units_per_step must be positive, got {units_per_step}")
        if self.terms is not None:
            t_fixed = max(self.terms.t_memory, self.terms.t_collective)
            return t_fixed, self.terms.t_compute / units_per_step
        return 0.0, self.mean_s / units_per_step


@dataclass
class ScopingResult:
    rows: list = field(default_factory=list)

    def param_names(self) -> list:
        return list(self.rows[0].params) if self.rows else []

    def to_arrays(self):
        names = self.param_names()
        X = np.array([[r.params[n] for n in names] for r in self.rows], float)
        y = np.array([r.cost() for r in self.rows], float)
        return names, X, y


def _grid(grid: dict[str, Iterable]) -> list[dict]:
    names = list(grid)
    return [dict(zip(names, vals)) for vals in itertools.product(*grid.values())]


class ContainerStress:
    """workload_fn(params: dict) must return a zero-arg callable that executes one
    unit of work (inputs baked in / regenerated via MC draws) on the device the
    workload put its tensors on; for analytic mode, lower_fn(params, shape) returns
    (fn, meta_args) to count.
    """

    def __init__(self, hw: HardwareSpec = H100):
        self.hw = hw

    def run_measured(
        self,
        workload_fn: Callable[[dict], Callable[[], Any]],
        grid: dict[str, Iterable],
        reps: int = 3,
        constraint: Optional[Callable[[dict], bool]] = None,
        verbose: bool = False,
    ) -> ScopingResult:
        """Time every feasible grid cell: one warm-up call, then ``reps`` timed calls.

        A cell that runs out of device memory is recorded as infeasible and
        skipped; any other error propagates, so a kernel that fails to build or
        launch is never mistaken for an infeasible cell.
        """
        res = ScopingResult()
        for params in _grid(grid):
            if constraint and not constraint(params):
                continue
            try:
                run = workload_fn(params)
                run()  # warm-up
                sync()
            except torch.cuda.OutOfMemoryError as e:
                if verbose:
                    print(f"[containerstress] skip {params}: out of device memory ({e})")
                continue
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                sync()
                ts.append(time.perf_counter() - t0)
            r = CellResult(
                params=params, mean_s=float(np.mean(ts)), std_s=float(np.std(ts)), reps=reps
            )
            res.rows.append(r)
            if verbose:
                print(
                    f"[containerstress] {params} -> {r.mean_s * 1e3:.2f} ms "
                    f"(±{r.std_s * 1e3:.2f})"
                )
        return res

    def run_analytic(
        self,
        lower_fn: Callable[[dict, CloudShape], tuple],
        grid: dict[str, Iterable],
        shapes: list[CloudShape],
        n_steps_for_cost: float = 1000.0,
        constraint: Optional[Callable[[dict], bool]] = None,
        verbose: bool = False,
    ) -> ScopingResult:
        """Count every grid cell on every shape: ``lower_fn(params, shape) -> (fn,
        meta_args)``, the cell's step and its inputs as meta tensors, which
        ``hlo_analysis.analyze`` runs once. A cell that ``lower_fn`` finds infeasible
        by construction (it raises ValueError) is skipped; any other error propagates.
        Each shape must be one chip."""
        many = [s.name for s in shapes if s.chips != 1]
        if many:
            raise ValueError(f"analytic scoping of {many} waits for the port's distributed/")
        res = ScopingResult()
        for params in _grid(grid):
            if constraint and not constraint(params):
                continue
            for shape in shapes:
                try:
                    fn, args = lower_fn(params, shape)
                except ValueError as e:
                    if verbose:
                        print(f"[containerstress] {shape.name} {params} infeasible: {e}")
                    continue
                cost = analyze(fn, *args)
                terms = roofline(
                    cost.flops, cost.bytes_accessed, cost.collective_bytes, shape.chips, self.hw
                )
                usd = dollar_cost(terms.t_step, n_steps_for_cost, shape.chips, self.hw)
                r = CellResult(
                    params=dict(params, shape=shape.chips),
                    shape_name=shape.name,
                    terms=terms,
                    analysis=cost.as_dict(),
                    usd_per_1k_steps=usd,
                )
                res.rows.append(r)
                if verbose:
                    print(
                        f"[containerstress] {shape.name} {params}: "
                        f"t_step={terms.t_step * 1e3:.3f} ms dom={terms.dominant} "
                        f"${usd:.2f}/1k steps"
                    )
        return res
