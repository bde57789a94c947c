"""Fleet workload scenarios: scoping rows (CellResult per shape x batch) for the
two serving paths the repo models, feeding ``recommend()`` and ServiceModels.

* MSET surveillance service (``mset/service.py``): one request = one batch of
  sensor observations estimated against the memory-vector model.
* Transformer LM decode (``launch/serve.py``): one request = one decode step of
  a batched generation loop.

Rows are analytic rooflines (no compilation), so scenarios build in
milliseconds and the simulator stays CPU-cheap.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import get_config
from repro_torch.core.catalog import CATALOG, CloudShape
from repro_torch.core.cost_model import roofline
from repro_torch.core.recommender import Constraint
from repro_torch.core.scoping import CellResult
from repro_torch.fleet.simulator import FleetConfig, PoolConfig
from repro_torch.fleet.traces import (diurnal_trace, flash_crowd_trace,
                                poisson_trace)
from repro_torch.fleet.workload import (RequestClass, ServiceModel, Workload,
                                  service_model_from_cell)
from repro_torch.launch.serve import decode_flops_bytes
from repro_torch.mset.service import service_collective_bytes, service_flops_bytes

DEFAULT_BATCHES = (8, 32, 128, 512)


@dataclass
class Scenario:
    """A serving workload scoped across shapes and batch sizes."""
    name: str
    rows: list                       # CellResult, params include "batch"
    slo_s: float                     # per-request latency SLO
    units_per_step: float            # reference serving batch
    description: str = ""

    def rows_at(self, batch: float = None) -> list:
        b = self.units_per_step if batch is None else batch
        return [r for r in self.rows if float(r.params["batch"]) == float(b)]

    def constraint(self, service_frac: float = 0.5) -> Constraint:
        """Feasibility bound for shape picking: a full batch must clear in a
        fraction of the SLO (the rest is queueing headroom)."""
        return Constraint(max_step_latency_s=self.slo_s * service_frac)

    def service_for(self, shape_name: str, batch: float = None) -> ServiceModel:
        b = self.units_per_step if batch is None else batch
        cell = next(r for r in self.rows_at(b) if r.shape_name == shape_name)
        return service_model_from_cell(cell, b, name=f"{self.name}:{shape_name}")

    def cheapest_shape(self) -> str:
        """Smallest-chip shape present (baseline for static fleets)."""
        return min(self.rows_at(), key=lambda r: r.params["chips"]).shape_name

    def pool_for(self, shape_name: str, batch: float = None,
                 cold_start_s: float = 30.0, min_replicas: int = 0,
                 max_replicas: int = 1024,
                 initial_replicas: int = None) -> PoolConfig:
        """One replica pool of ``shape_name`` running this scenario's service."""
        return PoolConfig(service=self.service_for(shape_name, batch),
                          cold_start_s=cold_start_s,
                          min_replicas=min_replicas,
                          max_replicas=max_replicas,
                          initial_replicas=initial_replicas)

    def fleet_for(self, shape_names, batch: float = None,
                  cold_start_s: float = 30.0, min_replicas: int = 0,
                  max_replicas=1024, max_queue: float = None) -> FleetConfig:
        """A (possibly mixed) fleet over this scenario: one pool per shape
        name. ``max_replicas`` may be an int applied to every pool or a
        mapping ``shape_name -> quota`` (per-instance-type cloud quotas)."""
        quota = (max_replicas if isinstance(max_replicas, dict)
                 else {s: max_replicas for s in shape_names})
        pools = tuple(
            self.pool_for(s, batch, cold_start_s=cold_start_s,
                          min_replicas=min_replicas,
                          max_replicas=quota.get(s, 1024))
            for s in shape_names)
        return FleetConfig(pools, max_queue=max_queue)


def interactive_batch_workload(mean_rate_per_s: float, duration_s: float,
                               dt_s: float = 5.0, *,
                               interactive_frac: float = 0.4,
                               interactive_slo_s: float = 1.0,
                               batch_slo_s: float = 30.0,
                               n_seeds: int = 8, seed: int = 0) -> Workload:
    """Interactive-vs-batch mix: a diurnal interactive stream with a tight
    SLO sharing the fleet with steady batch/backfill traffic that can wait.
    The canonical case where discipline choice dominates raw capacity: FIFO
    makes interactive requests queue behind batch backlog."""
    inter = diurnal_trace(interactive_frac * mean_rate_per_s, duration_s,
                          dt_s, period_s=duration_s, n_seeds=n_seeds,
                          seed=seed)
    batch = poisson_trace((1.0 - interactive_frac) * mean_rate_per_s,
                          duration_s, dt_s, n_seeds=n_seeds, seed=seed + 1)
    return Workload(
        "interactive+batch",
        (RequestClass("interactive", interactive_slo_s, priority=0),
         RequestClass("batch", batch_slo_s, priority=1)),
        (inter, batch))


def tiered_sla_workload(mean_rate_per_s: float, duration_s: float,
                        dt_s: float = 5.0, *,
                        tiers=(("gold", 1.0, 0.2), ("silver", 4.0, 0.3),
                               ("bronze", 60.0, 0.5)),
                        peak_mult: float = 2.0, burst_width_s: float = None,
                        n_seeds: int = 8, seed: int = 0) -> Workload:
    """Tiered-SLA mix: (name, slo_s, traffic share) tiers all riding the same
    flash-crowd demand shape (independently sampled per tier), priorities in
    tier order. ``mean_rate_per_s`` is the off-peak total rate; the
    coincident bursts peak at ``peak_mult`` x that. The burst forces
    queueing, which is where the disciplines separate: EDF/priority hold
    gold's deadline through the crowd by lending bronze's slack to the
    queue, so they meet every tier's SLO at well below peak capacity, while
    FIFO must be provisioned for the peak."""
    shares = [t[2] for t in tiers]
    total = sum(shares)
    width = duration_s / 30 if burst_width_s is None else burst_width_s
    classes, traces = [], []
    for i, (name, slo_s, share) in enumerate(tiers):
        classes.append(RequestClass(name, slo_s, priority=i))
        traces.append(flash_crowd_trace(
            (share / total) * mean_rate_per_s, duration_s, dt_s,
            peak_mult=peak_mult, burst_width_s=width,
            n_seeds=n_seeds, seed=seed + i))
    return Workload("tiered-sla", tuple(classes), tuple(traces))


def _row(shape: CloudShape, params: dict, flops: float, bytes_: float,
         coll: float, hbm_per_device: float) -> CellResult:
    # each shape is rated on its own hardware (v5e slices or H100 nodes)
    terms = roofline(flops, bytes_, coll if shape.chips > 1 else 0.0,
                     shape.chips, shape.hw)
    return CellResult(params=dict(params, chips=shape.chips),
                      shape_name=shape.name, terms=terms,
                      analysis={"peak_memory_per_device": hbm_per_device})


def mset_scenario(n_signals: int = 1024, n_memvec: int = 4096, fleet: int = 1,
                  slo_s: float = 1.0, batches=DEFAULT_BATCHES,
                  shapes=None) -> Scenario:
    """Sensor-fleet surveillance: a request is one observation batch estimated
    against ``fleet`` per-asset MSET models."""
    shapes = CATALOG if shapes is None else shapes
    model_bytes = 4.0 * (n_memvec ** 2 + 2 * n_memvec * n_signals) * fleet
    rows = []
    for shape in shapes:
        for b in batches:
            f, by = service_flops_bytes(n_signals, n_memvec, b)
            coll = service_collective_bytes(n_signals, b)
            hbm = model_bytes / shape.chips + 4.0 * b * n_signals
            rows.append(_row(shape, {"n_signals": n_signals,
                                     "n_memvec": n_memvec, "batch": b},
                             f * fleet, by * fleet, coll * fleet, hbm))
    return Scenario("mset-surveil", rows, slo_s, units_per_step=max(batches),
                    description=f"{fleet} asset model(s), {n_signals} signals, "
                                f"{n_memvec} memory vectors")


def lm_decode_scenario(arch: str = "minitron-4b", ctx: int = 512,
                       slo_s: float = 0.25, batches=DEFAULT_BATCHES,
                       shapes=None, smoke: bool = False) -> Scenario:
    """LM serving: a request is one decode step for one sequence; replicas run
    continuous batching at up to the reference batch."""
    shapes = CATALOG if shapes is None else shapes
    cfg = get_config(arch, smoke=smoke)
    counts = cfg.param_counts()
    dt_bytes = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    rows = []
    for shape in shapes:
        for b in batches:
            f, by = decode_flops_bytes(cfg, b, ctx=ctx)
            # weights all-gathered/reduced once per step when model-sharded
            coll = counts["active"] * dt_bytes * 0.25
            kv = 2.0 * b * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * ctx * dt_bytes
            hbm = (counts["total"] * dt_bytes + kv) / shape.chips
            rows.append(_row(shape, {"arch": arch, "ctx": ctx, "batch": b},
                             f, by, coll, hbm))
    return Scenario(f"lm-{arch}", rows, slo_s, units_per_step=max(batches),
                    description=f"{arch} decode @ ctx={ctx}, "
                                f"{counts['total'] / 1e9:.1f}B params")
