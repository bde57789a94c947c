"""``tune()`` — the outer autonomous loop over controller/fleet parameters.

The fleet simulator is already the paper's inner Monte Carlo loop (one
vectorized pass per config over every workload draw); ``tune`` wraps the
outer loop the paper runs over container configurations, with the
*controller's own knobs* as the design parameters:

    sample (LHS or grid from a seeded rng)
      -> race (paired successive halving + SPRT culling, ``racing.py``)
        -> refine (response surface over the surviving region, Pareto
           frontier, winner at full replicate budget)

The result is a ``TuningReport``: the framework now scopes itself — the same
sweep/race/fit methodology that picks a cloud shape picks ``horizon_s``,
``headroom``, cooldowns, quota mixes, or the scheduling discipline.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.recommender import recommend
from repro_torch.core.surfaces import _n_cols, fit_response_surface
from repro_torch.fleet import telemetry
from repro_torch.fleet.simulator import FleetConfig
from repro_torch.fleet.tuning.evaluate import (Objective, TuningScenario,
                                               evaluate_candidates)
from repro_torch.fleet.tuning.racing import exhaustive, race
from repro_torch.fleet.tuning.result import TuningReport, pareto_frontier


@dataclass(frozen=True)
class TuningBudget:
    """How much simulation to spend and how to allocate it. The replicate
    budget itself is the scenario workload's seed axis; ``n_candidates``
    only applies to the LHS sampler (the grid's size is its levels)."""
    n_candidates: int = 24
    sampler: str = "lhs"            # "lhs" | "grid"
    grid_levels: int = 3
    init_seeds: int = 2
    eta: int = 2
    racing: bool = True
    alpha: float = 0.05
    beta: float = 0.05


def tuning_scenario(scenario, workload, policy_cls, *, shape_name: str = None,
                    fleet: FleetConfig = None, cold_start_s=60.0,
                    max_queue: float = None, discipline: str = "fifo",
                    cold_start_seed: int = 0, name: str = None,
                    backend: str = "auto", robust: str = "worst_case",
                    tile: int = 256, device=None) -> TuningScenario:
    """Build a ``TuningScenario`` from a fleet ``Scenario`` (scoping rows).

    Single-pool by default: the pool's shape is ``shape_name`` or the
    scoping stack's own pick (``recommend()`` under the scenario constraint),
    and the policy context's rows are restricted to that shape so predictive
    candidates size against the pool they actually run on. Pass ``fleet``
    for heterogeneous tuning (e.g. ``HeterogeneousPredictivePolicy`` with
    ``quota:*`` dims). ``backend`` picks the simulator implementation
    candidates are scored on ("numpy" reference loop, "torch" compiled
    batched, or the default "auto": compiled when the family has a kernel,
    numpy otherwise) and ``device`` where the compiled one runs (``None``:
    the card). ``workload`` may be a sequence of Workloads/Traces —
    a portfolio whose per-trace scores reduce via ``robust`` (see
    ``TuningScenario``); ``tile`` bounds the compiled backend's per-dispatch
    candidate width.
    """
    if fleet is None:
        if shape_name is None:
            rec = recommend(scenario.rows_at(), scenario.constraint())
            if rec.shape is None:
                raise ValueError("tuning_scenario: no feasible shape "
                                 f"({rec.reason})")
            shape_name = rec.shape.name
        fleet = FleetConfig((scenario.pool_for(shape_name,
                                               cold_start_s=cold_start_s),))
    pool_shapes = {p.service.shape.name for p in fleet.pools}
    rows = [r for r in scenario.rows if r.shape_name in pool_shapes]
    context = {"rows": rows, "constraint": scenario.constraint(),
               "units_per_step": scenario.units_per_step,
               "slo_s": scenario.slo_s}
    if name is None:
        if isinstance(workload, (list, tuple)):
            name = (f"{scenario.name}/portfolio"
                    f"[{','.join(getattr(w, 'name', 'trace') for w in workload)}]")
        else:
            name = f"{scenario.name}/{getattr(workload, 'name', 'trace')}"
    return TuningScenario(
        name=name,
        workload=workload, fleet=fleet, policy_cls=policy_cls,
        context=context, discipline=discipline, max_queue=max_queue,
        cold_start_seed=cold_start_seed, backend=backend, robust=robust,
        tile=tile, device=device)


def _fit_surface(space, evals, min_rounds: int = 2):
    """Response surface over the surviving region: log-log polynomial of the
    mean objective score against the numeric dims, fitted on the candidates
    that survived at least one cull (the racer spent real replicates there,
    so their means are trustworthy); falls back to every evaluated candidate
    when the surviving set alone is too small.

    The fit's r2 is a trust signal (the bench gate reads it), so a pool must
    leave residual degrees of freedom: with exactly as many points as design
    columns lstsq interpolates anything with r2 == 1. Require 2 spare points
    beyond the quadratic's columns before fitting on a pool.
    """
    names = [n for n in space.numeric_names()]
    if not names:
        return None, ()
    n_needed = _n_cols(len(names), 2) + 2
    for pool in ([e for e in evals if e.n_rounds >= min_rounds], evals):
        if len(pool) < n_needed:
            continue
        X = np.array([[float(e.params[n]) for n in names] for e in pool])
        y = np.array([e.mean_score() for e in pool])
        try:
            return fit_response_surface(names, X, y, degree=2), tuple(names)
        except ValueError:
            continue
    return None, ()


def warm_start_candidates(report: TuningReport, space, n: int, *,
                          seed: int = 0, jitter: float = 0.15) -> list:
    """Candidate configs seeded from an incumbent ``TuningReport``'s
    surviving region: the incumbent winner and the candidates that survived
    to the final racing round come in verbatim (anchors — a re-tune must
    never score worse than simply re-racing the incumbent), and the
    remaining slots are a small Latin-hypercube perturbation of the winner —
    per-dim stratified offsets of up to ``±jitter`` of each dim's unit range
    (``Dim.to_unit``/``from_unit``), so a drift re-tune explores the
    incumbent's neighbourhood instead of restarting blind. Dims of ``space``
    the incumbent never tuned (say the re-tune adds a knob) fall back to a
    fresh stratified draw."""
    if n < 1:
        raise ValueError("need n >= 1 candidates")
    rng = np.random.default_rng(seed)
    anchors, seen = [], set()
    max_rounds = max((e.n_rounds for e in report.evals), default=0)
    ranked = [report.winner] + sorted(
        (e for e in report.evals if e.n_rounds >= max_rounds),
        key=lambda e: e.mean_score())
    for e in ranked:
        if e is None:
            continue
        params = {d.name: e.params[d.name] for d in space.dims
                  if d.name in e.params}
        if len(params) != len(space.dims):
            continue        # the incumbent never tuned some dim: no anchor
        key = tuple(repr(params[k]) for k in space.names)
        if key in seen:
            continue
        seen.add(key)
        anchors.append(params)
        if len(anchors) >= n:
            break
    m = n - len(anchors)
    if m > 0:
        w = report.winner.params if report.winner is not None else {}
        configs = [dict() for _ in range(m)]
        for d in space.dims:
            strat = (rng.permutation(m) + rng.uniform(size=m)) / m
            if d.name in w:
                u0 = d.to_unit(w[d.name])
                u = np.clip(u0 + (strat - 0.5) * (2.0 * jitter), 0.0, 1.0)
            else:
                u = strat
            for i in range(m):
                configs[i][d.name] = d.from_unit(u[i])
        anchors.extend(configs)
    return anchors[:n]


def tune(scenario: TuningScenario, space, objective: Objective = None,
         budget: TuningBudget = None, *, seed: int = 0,
         baseline: dict = None,
         warm_start: TuningReport = None,
         warm_jitter: float = 0.15) -> TuningReport:
    """Autonomously scope the controller: search ``space`` for the config of
    ``scenario.policy_cls`` minimizing ``objective`` over the scenario's
    Monte Carlo workload. Fully deterministic under (``seed``, budget,
    scenario): same inputs, same winner.

    ``baseline`` (optional) is a hand-set config evaluated at full replicate
    budget on the same paired draws — the tuned-vs-default comparison
    ``TuningReport.dominates_baseline()`` reads.

    ``warm_start`` (optional) replaces the cold LHS design with
    ``warm_start_candidates``: the incumbent report's surviving region plus
    a ``±warm_jitter`` unit-space perturbation of its winner — the budgeted
    re-tune the closed-loop controller runs when the drift probe trips.
    """
    objective = objective or Objective()
    budget = budget or TuningBudget()
    with telemetry.span("tune", scenario=scenario.name,
                        backend=scenario.backend,
                        device=str(scenario.device)) as root:
        with telemetry.span("tune.sample", sampler=budget.sampler,
                            warm=warm_start is not None):
            if warm_start is not None:
                candidates = warm_start_candidates(
                    warm_start, space, budget.n_candidates, seed=seed,
                    jitter=warm_jitter)
            elif budget.sampler == "grid":
                candidates = space.grid(budget.grid_levels)
            elif budget.sampler == "lhs":
                candidates = space.sample_lhs(budget.n_candidates, seed=seed)
            else:
                raise ValueError(f"unknown sampler {budget.sampler!r}")

        with telemetry.span("tune.race", candidates=len(candidates),
                            racing=budget.racing):
            if budget.racing:
                rr = race(scenario, candidates, objective,
                          init_seeds=budget.init_seeds, eta=budget.eta,
                          alpha=budget.alpha, beta=budget.beta)
            else:
                rr = exhaustive(scenario, candidates, objective)

        with telemetry.span("tune.refine"):
            surface, names = _fit_surface(space, rr.evals)
            base_eval = None
            if baseline is not None:
                base_eval = evaluate_candidates(scenario, [baseline],
                                                objective)[0]

    return TuningReport(
        scenario_name=scenario.name,
        policy_family=getattr(scenario.policy_cls, "name",
                              scenario.policy_cls.__name__),
        objective=objective,
        winner=rr.winner,
        frontier=pareto_frontier(rr.evals),
        surface=surface, surface_names=names,
        sims_used=rr.sims_used, full_budget=rr.full_budget,
        baseline=base_eval, evals=rr.evals, space=space,
        robust=scenario.robust if scenario.n_traces > 1 else None,
        n_traces=scenario.n_traces,
        _scenario=scenario, spans=root)
