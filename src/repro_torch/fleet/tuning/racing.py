"""Successive-halving candidate racing with SPRT-flavored early culling.

The naive sweep spends ``n_candidates x n_seeds`` simulations; most of that
budget goes to configs that are obviously dominated after two replicates.
Racing spends the budget where the decision is actually close:

* rounds double the replicate count (seed slices are *shared* across
  candidates, so per-seed score differences vs the incumbent are paired —
  ``evaluate.py``'s common-random-numbers setup; on the torch backend each
  round's surviving slate is scored as ONE compiled candidate x seed batch,
  with ``sims_used`` accounting unchanged);
* a candidate is culled early when the sequential log-likelihood ratio of its
  paired score deficit vs the incumbent crosses the Wald threshold
  ``ln((1-beta)/alpha)`` — the same two-hypothesis sequential test
  ``mset/sprt.py`` runs on MSET residuals, here on "is this config worse than
  the incumbent by at least one per-seed noise sigma?";
* independently of the SPRT, each round keeps at most ``ceil(n / eta)``
  survivors (classic successive halving), which bounds total spend at a small
  multiple of ``n_candidates x init_seeds`` regardless of how noisy the
  scenario is.

The full-budget reference (``exhaustive``) exists for benchmarking the
racer: on the seeded scenarios the tests pin, racing returns the same winner
for <= 40% of the exhaustive simulation budget.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.fleet import telemetry
from repro_torch.fleet.tuning.evaluate import (CandidateEval, Objective,
                                               TuningScenario,
                                               evaluate_candidates,
                                               evaluate_candidates_column)

_EPS = 1e-12


@dataclass
class RaceResult:
    evals: list                      # CandidateEval per candidate (all)
    winner: CandidateEval
    survivors: list                  # full-budget finalists (CandidateEval)
    sims_used: int                   # candidate x seed x trace sims spent
    full_budget: int                 # n_candidates x n_seeds x n_traces
    culled_at_round: dict = field(default_factory=dict)  # cand idx -> round

    @property
    def budget_frac(self) -> float:
        return self.sims_used / max(self.full_budget, 1)


def _sprt_cull(deficits: np.ndarray, alpha: float, beta: float) -> bool:
    """Wald SPRT on paired per-seed score deficits d_i = cand_i - incumbent_i.

    H0: the candidate matches the incumbent (mean deficit 0); H1: it is worse
    by one per-seed noise sigma. With the effect size theta = sigma the
    log-likelihood ratio after n paired replicates reduces to
    ``sum(d)/sigma - n/2``; cull when it crosses ``ln((1-beta)/alpha)``.
    Degenerate spread (paired deficits all but equal) short-circuits on the
    sign: deterministically worse is culled, deterministically tied kept.
    """
    d = np.asarray(deficits, float)
    n = len(d)
    if n < 2:
        return False
    sigma = float(d.std(ddof=1))
    if sigma < _EPS:
        return bool(d.mean() > _EPS)
    llr = float(d.sum()) / sigma - n / 2.0
    return llr >= np.log((1.0 - beta) / alpha)


def race(scenario: TuningScenario, candidates: list, objective: Objective,
         *, init_seeds: int = 2, eta: int = 2, alpha: float = 0.05,
         beta: float = 0.05, min_survivors: int = 2) -> RaceResult:
    """Race ``candidates`` to the scenario's full replicate budget, culling
    dominated configs early. Returns every candidate's evidence (culled ones
    keep the seeds they saw), the full-budget survivors, and the spend. On a
    portfolio scenario racing operates on the robust per-seed score and each
    replicate costs ``n_traces`` simulations (all ridden by the same
    dispatch), so ``sims_used``/``full_budget`` count
    candidate x seed x trace trajectories."""
    n_seeds = scenario.n_seeds
    n = len(candidates)
    K = scenario.n_traces
    if n == 0:
        raise ValueError("race needs at least one candidate")
    init_seeds = int(np.clip(init_seeds, 1, n_seeds))
    evals = [None] * n
    alive = list(range(n))
    culled_at = {}
    sims = 0
    s_done = 0               # replicates every live candidate has seen
    rnd = 0
    while s_done < n_seeds:
        s_next = min(max(s_done * eta, init_seeds), n_seeds)
        with telemetry.span("tune.race.round", round=rnd, alive=len(alive),
                            s0=s_done, s1=s_next):
            fresh = evaluate_candidates(
                scenario, [candidates[i] for i in alive], objective,
                s0=s_done, s1=s_next)
        sims += len(alive) * (s_next - s_done) * K
        for i, ev in zip(alive, fresh):
            if evals[i] is None:
                evals[i] = ev
            else:
                evals[i].extend(ev)
            evals[i].n_rounds = rnd + 1
        s_done = s_next

        if len(alive) > 1:
            with telemetry.span("tune.race.cull", round=rnd):
                by_score = sorted(alive, key=lambda i: evals[i].mean_score())
                inc = evals[by_score[0]]
                keep = [by_score[0]]
                for i in by_score[1:]:
                    if _sprt_cull(evals[i].score - inc.score, alpha, beta):
                        culled_at[i] = rnd
                        telemetry.counter("tuning_culled_total", reason="sprt")
                    else:
                        keep.append(i)
                # successive halving on top of the SPRT: even when the test is
                # inconclusive for many candidates, at most ceil(|alive|/eta)
                # advance to the next (eta-x costlier) rung
                cap = max(int(np.ceil(len(alive) / eta)), min_survivors)
                if s_done < n_seeds and len(keep) > cap:
                    for i in keep[cap:]:
                        culled_at[i] = rnd
                        telemetry.counter("tuning_culled_total",
                                          reason="halving")
                    keep = keep[:cap]
            alive = keep
        rnd += 1
        if len(alive) == 1 and s_done < n_seeds:
            # a lone survivor still gets its full-budget evaluation (the
            # winner's headline numbers must use every replicate)
            with telemetry.span("tune.race.round", round=rnd,
                                alive=1, s0=s_done, s1=n_seeds):
                fresh = evaluate_candidates(
                    scenario, [candidates[alive[0]]], objective,
                    s0=s_done, s1=n_seeds)
            sims += (n_seeds - s_done) * K
            evals[alive[0]].extend(fresh[0])
            evals[alive[0]].n_rounds = rnd + 1
            s_done = n_seeds

    survivors = [evals[i] for i in alive]
    winner = min(survivors, key=lambda e: e.mean_score())
    return RaceResult(evals=[e for e in evals if e is not None],
                      winner=winner, survivors=survivors, sims_used=sims,
                      full_budget=n * n_seeds * K, culled_at_round=culled_at)


def exhaustive(scenario: TuningScenario, candidates: list,
               objective: Objective) -> RaceResult:
    """The naive full-budget sweep: every candidate on every replicate (and,
    on a portfolio, every trace). The reference racing is measured against."""
    evals = evaluate_candidates(scenario, candidates, objective)
    winner = min(evals, key=lambda e: e.mean_score())
    full = len(candidates) * scenario.n_seeds * scenario.n_traces
    return RaceResult(evals=evals, winner=winner, survivors=list(evals),
                      sims_used=full, full_budget=full)


def race_column(scenario: TuningScenario, candidates: list,
                objective: Objective, slo_values, *, init_seeds: int = 2,
                eta: int = 2, alpha: float = 0.05, beta: float = 0.05,
                min_survivors: int = 2):
    """Race one shared candidate slate for a whole column of SLO tiers,
    every round ONE compiled dispatch over the union of tier-alive
    candidates (``evaluate_candidates_column``: single-class tiers share
    bin-exact dynamics, only the host-side SLO accounting differs).

    Each tier runs ``race``'s exact bookkeeping — same rung schedule, SPRT
    cull, halving cap and full-budget winner evidence — against its own SLO
    bar, so per-tier winners, survivors and per-tier ``sims_used`` are
    identical to racing each tier separately; what changes is the physical
    spend: a candidate alive in several tiers simulates once per round, not
    once per tier. Returns ``(results, sims_shared)`` — per-tier
    ``RaceResult``s aligned with ``slo_values`` plus the actual shared
    trajectory count — or ``None`` when the slate cannot batch (caller
    races tiers separately)."""
    n_seeds = scenario.n_seeds
    n = len(candidates)
    K = scenario.n_traces
    if n == 0:
        raise ValueError("race needs at least one candidate")
    n_tiers = len(slo_values)
    init_seeds = int(np.clip(init_seeds, 1, n_seeds))
    evals = [[None] * n for _ in range(n_tiers)]
    alive = [list(range(n)) for _ in range(n_tiers)]
    culled_at = [{} for _ in range(n_tiers)]
    tier_sims = [0] * n_tiers
    sims_shared = 0
    s_done = 0
    rnd = 0
    while s_done < n_seeds:
        s_next = min(max(s_done * eta, init_seeds), n_seeds)
        union = sorted(set().union(*map(set, alive)))
        with telemetry.span("tune.race.round", round=rnd, alive=len(union),
                            s0=s_done, s1=s_next, tiers=n_tiers):
            tiered = evaluate_candidates_column(
                scenario, [candidates[i] for i in union], objective,
                slo_values, s0=s_done, s1=s_next)
        if tiered is None:
            return None
        sims_shared += len(union) * (s_next - s_done) * K
        pos = {i: j for j, i in enumerate(union)}
        for ti in range(n_tiers):
            ev_t, alive_t = evals[ti], alive[ti]
            tier_sims[ti] += len(alive_t) * (s_next - s_done) * K
            for i in alive_t:
                ev = tiered[ti][pos[i]]
                if ev_t[i] is None:
                    ev_t[i] = ev
                else:
                    ev_t[i].extend(ev)
                ev_t[i].n_rounds = rnd + 1
        s_done = s_next

        for ti in range(n_tiers):
            ev_t, alive_t = evals[ti], alive[ti]
            if len(alive_t) <= 1:
                continue
            with telemetry.span("tune.race.cull", round=rnd, tier=ti):
                by_score = sorted(alive_t,
                                  key=lambda i: ev_t[i].mean_score())
                inc = ev_t[by_score[0]]
                keep = [by_score[0]]
                for i in by_score[1:]:
                    if _sprt_cull(ev_t[i].score - inc.score, alpha, beta):
                        culled_at[ti][i] = rnd
                        telemetry.counter("tuning_culled_total",
                                          reason="sprt")
                    else:
                        keep.append(i)
                cap = max(int(np.ceil(len(alive_t) / eta)), min_survivors)
                if s_done < n_seeds and len(keep) > cap:
                    for i in keep[cap:]:
                        culled_at[ti][i] = rnd
                        telemetry.counter("tuning_culled_total",
                                          reason="halving")
                    keep = keep[:cap]
            alive[ti] = keep
        rnd += 1
        # a tier's lone survivor keeps riding the shared rounds to the full
        # replicate budget (adjacent slices concatenate to exactly the
        # one-shot evidence ``race``'s fast path collects)

    results = []
    for ti in range(n_tiers):
        survivors = [evals[ti][i] for i in alive[ti]]
        winner = min(survivors, key=lambda e: e.mean_score())
        results.append(RaceResult(
            evals=[e for e in evals[ti] if e is not None], winner=winner,
            survivors=survivors, sims_used=tier_sims[ti],
            full_budget=n * n_seeds * K, culled_at_round=culled_at[ti]))
    return results, sims_shared
