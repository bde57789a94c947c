"""Offline oracle builder: sweep ``tune()`` over a grid of workload regimes.

"Don't train models. Build oracles!": instead of re-running the nested-loop
Monte Carlo tuner per customer, run it *once per grid cell* offline —
embarrassingly parallel on the compiled backend — over a declarative grid of
(mean rate x burstiness x SLO tier), and persist every cell's winner and
Pareto frontier into a versioned, serializable :class:`OracleTable`. Online,
scoping is then a constant-time lookup (:mod:`repro_torch.fleet.oracle.oracle`);
the simulator is demoted to the offline builder here and the spot-check
verifier (:mod:`repro_torch.fleet.oracle.verify`).

Each cell is tuned against a *canonical* synthetic trace realizing the
cell's features exactly: a steady Poisson stream when ``burstiness == 1``,
else a flash-crowd profile whose peak multiplier is solved so peak/mean
matches the cell's burstiness. The tuner seed is derived from the cell's
(rate, burstiness) column — distinct columns explore distinct candidate
sets, but every SLO tier within a column races the *same* candidates, which
is what makes the interpolated score provably monotone in SLO tightness (a
config's score can only improve as the deadline loosens, and the min over a
shared candidate set inherits that ordering).
"""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field

import numpy as np

from repro_torch.fleet import telemetry
from repro_torch.fleet.oracle.features import TraceFeatures, featurize
from repro_torch.fleet.traces import Trace, flash_crowd_trace, poisson_trace
from repro_torch.fleet.tuning.evaluate import Objective, TuningScenario
from repro_torch.fleet.tuning.space import ParamSpace
from repro_torch.fleet.tuning.tuner import TuningBudget, tune
from repro_torch.fleet.workload import Workload

_LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class OracleGrid:
    """Declarative sweep grid: the workload regimes the oracle will answer
    for. ``mean_rates`` and ``slos`` are treated as log-scaled axes (rates
    and deadlines span decades), ``burstiness`` as linear; every axis must
    be strictly increasing. The canonical trace per cell is generated at
    ``duration_s``/``dt_s`` with ``n_seeds`` Monte Carlo replicates."""
    mean_rates: tuple               # requests/s, > 0, strictly increasing
    burstiness: tuple               # peak/mean >= 1, strictly increasing
    slos: tuple                     # seconds, > 0, strictly increasing
    duration_s: float = 1800.0
    dt_s: float = 10.0
    n_seeds: int = 4
    seed: int = 0
    burst_width_frac: float = 1.0 / 16.0    # flash-crowd width / duration

    def __post_init__(self):
        for name, axis, lo in (("mean_rates", self.mean_rates, 0.0),
                               ("burstiness", self.burstiness, 1.0 - 1e-12),
                               ("slos", self.slos, 0.0)):
            vals = tuple(float(v) for v in axis)
            object.__setattr__(self, name, vals)
            if not vals:
                raise ValueError(f"grid axis {name} is empty")
            if any(v <= lo for v in vals) or not all(np.isfinite(vals)):
                raise ValueError(f"grid axis {name} needs finite values "
                                 f"> {lo}: {vals}")
            if any(b <= a for a, b in zip(vals, vals[1:])):
                raise ValueError(f"grid axis {name} must be strictly "
                                 f"increasing: {vals}")

    @property
    def shape(self) -> tuple:
        return (len(self.mean_rates), len(self.burstiness), len(self.slos))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.shape))

    def cells(self):
        """((i, j, k), mean_rate, burstiness, slo_s) per grid cell."""
        for i, mr in enumerate(self.mean_rates):
            for j, b in enumerate(self.burstiness):
                for k, slo in enumerate(self.slos):
                    yield (i, j, k), mr, b, slo


def canonical_trace(mean_rate: float, burstiness: float, *,
                    duration_s: float, dt_s: float, n_seeds: int = 4,
                    seed: int = 0,
                    burst_width_frac: float = 1.0 / 16.0) -> Trace:
    """The grid cell's representative trace: exact mean rate AND exact
    peak/mean burstiness.

    ``flash_crowd_trace``'s ``peak_mult`` multiplies the *base* rate, not
    the mean — a Gaussian burst raises the mean too, so peak/mean ends up
    below ``peak_mult``. Solve for the multiplier that lands the requested
    burstiness: with ``g`` the unit burst profile and ``gm = mean(g)``,
    ``peak/mean = pm / (1 + (pm - 1) gm)`` gives
    ``pm = B (1 - gm) / (1 - B gm)``, feasible while ``B < 1/gm`` (a very
    narrow trace can realize very high burstiness; a wide one cannot)."""
    if burstiness < 1.0:
        raise ValueError(f"burstiness must be >= 1, got {burstiness}")
    if burstiness <= 1.0 + 1e-9:
        return poisson_trace(mean_rate, duration_s, dt_s,
                             n_seeds=n_seeds, seed=seed)
    width = duration_s * burst_width_frac
    # unit burst profile g (peak ~1 at center) from a peak_mult=2 probe:
    # rate = base * (1 + (pm-1) g), so the probe's (rate - 1) IS g as binned
    probe = flash_crowd_trace(1.0, duration_s, dt_s, peak_mult=2.0,
                              burst_width_s=width, n_seeds=1, seed=seed)
    g = probe.rate - 1.0
    gm, gmax = float(g.mean()), float(g.max())
    # solve peak/mean = (1 + (pm-1) gmax) / (1 + (pm-1) gm) = burstiness
    denom = gmax - burstiness * gm
    if denom <= 0:
        raise ValueError(
            f"burstiness {burstiness:g} is not realizable with a "
            f"{burst_width_frac:.3g}-duration burst (max {gmax / gm:.2f}); "
            f"narrow burst_width_frac or lower the axis")
    pm = 1.0 + (burstiness - 1.0) / denom
    rate = 1.0 + (pm - 1.0) * g
    rate *= mean_rate / rate.mean()
    arrivals = np.random.default_rng(seed).poisson(
        rate[None, :] * dt_s, size=(n_seeds, len(rate)))
    return Trace(f"canonical-b{burstiness:g}", dt_s, rate, arrivals)


@dataclass(frozen=True)
class OracleCell:
    """One precomputed answer: the tuner's winner for a workload regime."""
    idx: tuple                      # (i, j, k) into the grid axes
    mean_rate: float
    burstiness: float
    slo_s: float
    features: TraceFeatures         # of the canonical trace actually tuned
    winner: dict                    # winning params (verbatim from tune())
    cost_usd_hr: float
    attainment: float               # worst-class SLO attainment of winner
    score: float                    # objective scalarization of winner
    frontier: tuple = ()            # ({params, cost_usd_hr, attainment}, ...)

    def to_json(self) -> dict:
        return {"idx": list(self.idx), "mean_rate": self.mean_rate,
                "burstiness": self.burstiness, "slo_s": self.slo_s,
                "features": self.features.as_dict(),
                "winner": dict(self.winner),
                "cost_usd_hr": self.cost_usd_hr,
                "attainment": self.attainment, "score": self.score,
                "frontier": [dict(f) for f in self.frontier]}

    @staticmethod
    def from_json(d: dict) -> "OracleCell":
        return OracleCell(
            idx=tuple(int(v) for v in d["idx"]),
            mean_rate=float(d["mean_rate"]),
            burstiness=float(d["burstiness"]), slo_s=float(d["slo_s"]),
            features=TraceFeatures.from_dict(d["features"]),
            winner=dict(d["winner"]), cost_usd_hr=float(d["cost_usd_hr"]),
            attainment=float(d["attainment"]), score=float(d["score"]),
            frontier=tuple(dict(f) for f in d.get("frontier", ())))


@dataclass
class OracleTable:
    """The compiled artifact: every grid cell's winner + frontier, plus the
    search space and objective needed to interpolate between cells. JSON on
    disk is versioned; ``ScopingOracle`` (oracle.py) is the query engine."""
    FORMAT = "oracle-table"
    VERSION = 1

    grid: OracleGrid
    space: ParamSpace
    objective: Objective
    policy_family: str
    fleet_label: str
    cells: dict = field(default_factory=dict)    # idx tuple -> OracleCell
    build_info: dict = field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    def cell(self, idx: tuple) -> OracleCell:
        return self.cells[tuple(idx)]

    def to_json(self) -> dict:
        return {
            "format": self.FORMAT, "version": self.VERSION,
            "grid": {"mean_rates": list(self.grid.mean_rates),
                     "burstiness": list(self.grid.burstiness),
                     "slos": list(self.grid.slos),
                     "duration_s": self.grid.duration_s,
                     "dt_s": self.grid.dt_s, "n_seeds": self.grid.n_seeds,
                     "seed": self.grid.seed,
                     "burst_width_frac": self.grid.burst_width_frac},
            "space": self.space.to_json(),
            "objective": self.objective.to_json(),
            "policy_family": self.policy_family,
            "fleet_label": self.fleet_label,
            "cells": [c.to_json() for _, c in sorted(self.cells.items())],
            "build_info": dict(self.build_info),
        }

    @staticmethod
    def from_json(d: dict) -> "OracleTable":
        if d.get("format") != OracleTable.FORMAT:
            raise ValueError(f"not an oracle table "
                             f"(format={d.get('format')!r})")
        if int(d.get("version", -1)) > OracleTable.VERSION:
            raise ValueError(f"oracle table version {d.get('version')} is "
                             f"newer than this reader "
                             f"(<= {OracleTable.VERSION})")
        g = d["grid"]
        grid = OracleGrid(
            mean_rates=tuple(g["mean_rates"]),
            burstiness=tuple(g["burstiness"]), slos=tuple(g["slos"]),
            duration_s=float(g["duration_s"]), dt_s=float(g["dt_s"]),
            n_seeds=int(g["n_seeds"]), seed=int(g["seed"]),
            burst_width_frac=float(g.get("burst_width_frac", 1.0 / 16.0)))
        cells = {}
        for cd in d.get("cells", []):
            c = OracleCell.from_json(cd)
            cells[c.idx] = c
        return OracleTable(
            grid=grid, space=ParamSpace.from_json(d["space"]),
            objective=Objective.from_json(d["objective"]),
            policy_family=d["policy_family"],
            fleet_label=d.get("fleet_label", ""),
            cells=cells, build_info=dict(d.get("build_info", {})))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, default=float)
            f.write("\n")

    @staticmethod
    def load(path) -> "OracleTable":
        with open(path) as f:
            return OracleTable.from_json(json.load(f))

    def summary(self) -> str:
        g = self.grid
        bi = self.build_info
        lines = [
            f"oracle table: {self.policy_family} on {self.fleet_label}",
            f"  grid {g.shape[0]}x{g.shape[1]}x{g.shape[2]} = "
            f"{self.n_cells} cells "
            f"(rate {g.mean_rates[0]:g}..{g.mean_rates[-1]:g}/s, "
            f"burstiness {g.burstiness[0]:g}..{g.burstiness[-1]:g}, "
            f"slo {g.slos[0]:g}..{g.slos[-1]:g}s)",
            f"  built with {bi.get('sims_used', '?')} candidate-replicate "
            f"simulations ({bi.get('tune_equivalents', '?')} fresh-tune "
            f"equivalents)",
        ]
        return "\n".join(lines)


def _frontier_entries(report) -> tuple:
    return tuple({"params": dict(e.params),
                  "cost_usd_hr": e.mean_cost(),
                  "attainment": e.mean_attainment(),
                  "score": e.mean_score()} for e in report.frontier)


def _tune_column(scen0, candidates, space, objective, budget, slos):
    """Tune every SLO tier of one (rate, burstiness) column against the
    shared candidate slate with SHARED compiled dispatches
    (``race_column``): single-class tiers have bin-exact identical dynamics
    — the SLO only enters the host-side exact-latency accounting — so the
    column's K tiers cost one tier's simulations instead of K. Per-tier
    racing bookkeeping (SPRT, halving, full-budget winner evidence) is
    ``race``'s own, so each tier's winner, frontier and fitted surface are
    identical to a standalone per-cell ``tune()``. Returns
    ``(reports, sims_shared)`` aligned with ``slos``, or ``None`` when the
    slate cannot batch (caller tunes cells separately)."""
    from repro_torch.fleet.tuning.racing import race_column
    from repro_torch.fleet.tuning.result import TuningReport, pareto_frontier
    from repro_torch.fleet.tuning.tuner import _fit_surface

    got = race_column(scen0, candidates, objective, slos,
                      init_seeds=budget.init_seeds, eta=budget.eta,
                      alpha=budget.alpha, beta=budget.beta)
    if got is None:
        return None
    results, sims_shared = got
    reports = []
    for rr in results:
        surface, names = _fit_surface(space, rr.evals)
        reports.append(TuningReport(
            scenario_name=scen0.name,
            policy_family=getattr(scen0.policy_cls, "name",
                                  scen0.policy_cls.__name__),
            objective=objective, winner=rr.winner,
            frontier=pareto_frontier(rr.evals), surface=surface,
            surface_names=names, sims_used=rr.sims_used,
            full_budget=rr.full_budget, evals=rr.evals, space=space,
            _scenario=scen0, spans=None))
    return reports, sims_shared


def build_oracle(grid: OracleGrid, fleet, policy_cls, space: ParamSpace, *,
                 objective: Objective = None, budget: TuningBudget = None,
                 context: dict = None, discipline: str = "fifo",
                 max_queue: float = None, backend: str = "auto",
                 name: str = "oracle", column_batch: bool = True,
                 device=None) -> OracleTable:
    """Sweep ``tune()`` over every grid cell and compile the answers.

    Per cell: synthesize the canonical trace for (mean_rate, burstiness),
    wrap it into a single-class workload at the cell's SLO, tune
    ``policy_cls`` over ``space`` with the column-derived seed, and record
    the winner + Pareto frontier. Deterministic under (grid, budget, seed).

    With ``column_batch`` (the default) and a compiled backend, every SLO
    tier in a (rate, burstiness) column rides the SAME dispatches: tiers
    already race a shared candidate set on shared arrivals (the
    SLO-monotonicity invariant), and a single-class workload's dynamics
    never see the SLO, so one compiled racing round scores the whole column
    and each tier re-assembles its own accounting on the host
    (``race_column``). Winners and frontiers are identical to the per-cell
    sweep; ``build_info["sims_used"]`` counts the trajectories actually
    simulated, so the build's amortization (``tune_equivalents``) honestly
    drops by ~the column height. Cells fall back to per-cell ``tune()``
    when the slate cannot batch (numpy backend, custom families,
    exhaustive budgets). ``device`` is where the compiled backend runs
    (``None``: the card).
    """
    objective = objective or Objective()
    budget = budget or TuningBudget(n_candidates=12, init_seeds=2)
    context = dict(context or {})
    fleet_label = "+".join(p.label for p in fleet.pools)
    cells, sims_total = {}, 0
    n_slos = len(grid.slos)
    with telemetry.span("oracle.build", n_cells=grid.n_cells,
                        backend=backend, column_batch=column_batch):
        for i, mr in enumerate(grid.mean_rates):
            for j, burst in enumerate(grid.burstiness):
                # Trace and tuner seeds depend only on the (rate,
                # burstiness) column, never on the SLO index: every SLO
                # tier in a column must race the same candidate set on the
                # same arrivals for the interpolated score to stay monotone
                # in SLO tightness.
                col_seed = grid.seed + 7919 * (1 + i * 31 + j)
                tr = canonical_trace(
                    mr, burst, duration_s=grid.duration_s, dt_s=grid.dt_s,
                    n_seeds=grid.n_seeds, seed=col_seed,
                    burst_width_frac=grid.burst_width_frac)
                reports = None
                if column_batch and backend != "numpy" and budget.racing \
                        and n_slos > 1:
                    scen0 = TuningScenario(
                        name=f"{name}/col({i},{j})",
                        workload=Workload.from_trace(tr, grid.slos[0]),
                        fleet=fleet, policy_cls=policy_cls,
                        context=dict(context, slo_s=grid.slos[0]),
                        discipline=discipline, max_queue=max_queue,
                        backend=backend, device=device)
                    if budget.sampler == "grid":
                        candidates = space.grid(budget.grid_levels)
                    else:
                        candidates = space.sample_lhs(budget.n_candidates,
                                                      seed=col_seed)
                    with telemetry.span("oracle.column", col=f"({i},{j})",
                                        rate=mr, burstiness=burst,
                                        tiers=n_slos):
                        got = _tune_column(scen0, candidates, space,
                                           objective, budget, grid.slos)
                    if got is not None:
                        reports, sims_shared = got
                        sims_total += sims_shared
                for k, slo in enumerate(grid.slos):
                    idx = (i, j, k)
                    if reports is not None:
                        report = reports[k]
                    else:
                        wl = Workload.from_trace(tr, slo)
                        scen = TuningScenario(
                            name=f"{name}/cell{idx}", workload=wl,
                            fleet=fleet, policy_cls=policy_cls,
                            context=dict(context, slo_s=slo),
                            discipline=discipline, max_queue=max_queue,
                            backend=backend, device=device)
                        with telemetry.span("oracle.cell", idx=str(idx),
                                            rate=mr, burstiness=burst,
                                            slo=slo):
                            report = tune(scen, space, objective, budget,
                                          seed=col_seed)
                        sims_total += report.sims_used
                    cells[idx] = OracleCell(
                        idx=idx, mean_rate=mr, burstiness=burst, slo_s=slo,
                        features=featurize(tr),
                        winner=dict(report.winner.params),
                        cost_usd_hr=report.winner.mean_cost(),
                        attainment=report.winner.mean_attainment(),
                        score=report.winner.mean_score(),
                        frontier=_frontier_entries(report))
                    _LOG.info(
                        "oracle cell %s: rate %.3g/s burst %.2f slo %.3gs "
                        "-> %s ($%.2f/hr @ %.4f)", idx, mr, burst, slo,
                        cells[idx].winner, cells[idx].cost_usd_hr,
                        cells[idx].attainment)
    per_cell = max(budget.n_candidates * grid.n_seeds, 1)
    table = OracleTable(
        grid=grid, space=space, objective=objective,
        policy_family=getattr(policy_cls, "name", policy_cls.__name__),
        fleet_label=fleet_label, cells=cells,
        build_info={"sims_used": sims_total,
                    "n_cells": grid.n_cells,
                    "tune_equivalents": sims_total / per_cell,
                    "seed": grid.seed, "backend": backend})
    telemetry.event("oracle_built", n_cells=grid.n_cells,
                    sims_used=sims_total, policy_family=table.policy_family)
    return table
