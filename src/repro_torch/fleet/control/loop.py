"""Closed-loop autonomous control: observe -> decide -> act, mid-trace.

This closes the ROADMAP loop the drift probe left open. A
:class:`ClosedLoopController` runs one continuous fleet trace in segments
(:class:`~repro_torch.fleet.simulator.SegmentedSimulation`, full queue/in-flight
state carried across boundaries) and after each segment feeds the observed
telemetry window (per-bin service time, utilization, queue depth) into a
:class:`~repro_torch.fleet.telemetry.DriftProbe`. When the probe alarms it:

1. estimates the service degradation factor from the observed service-time
   stream against the fitted baseline,
2. **re-scopes**: re-runs the analytic shape recommendation
   (``repro_torch.core.recommender.recommend``) with every roofline term inflated
   by the estimate — validating whether the deployed shape is still the
   right one under the degraded service model (hardware is never exchanged
   mid-trace: billing pins pool identity and prices, so a shape downgrade
   is advice for the next deploy, recorded in the result),
3. **consults the scoping oracle** (when one is attached): featurizes the
   *remaining* workload, inflates the rate axis by the degradation estimate
   (a fleet serving f-times slower is scoped as f-times the traffic), and
   looks the regime up in the precompiled :class:`ScopingOracle` table — a
   microsecond answer. A hit is confirmed with one cheap paired evaluation
   (active config vs interpolated answer vs nearest-cell winner on the
   degraded tail) before swapping; only a *miss* (query outside the gridded
   region) falls through to the expensive path:
4. **re-tunes**: a budgeted warm-started ``tune()`` over the remaining
   workload under the degraded service model, seeded from the incumbent
   ``TuningReport``'s surviving region (``warm_start_candidates``) on the
   compiled backend, with the incumbent config as the racing baseline,
5. **acts**: if the chosen winner beats the incumbent on the degraded
   tail, hot-swaps the winning policy at the next segment boundary
   (``SegmentedSimulation.swap``) — the finished trace is still one
   continuous run — then re-fits the probe on the model-predicted post-swap
   telemetry and holds a cooldown before checking again.

The simulation is the world: the controller sees only telemetry, and drift
cases (:mod:`repro_torch.fleet.control.scenario`) inject degradation by swapping a
service-degraded fleet into the live run at a scheduled bin.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.cost_model import RooflineTerms
from repro_torch.core.recommender import recommend
from repro_torch.fleet import telemetry
from repro_torch.fleet.control.scenario import DriftCase, tail_workload
from repro_torch.fleet.simulator import SegmentedSimulation, SimResult
from repro_torch.fleet.telemetry.drift import (DriftProbe, degrade_fleet,
                                               telemetry_matrix)
from repro_torch.fleet.tuning.evaluate import (Objective, TuningScenario,
                                               evaluate_candidates)
from repro_torch.fleet.tuning.tuner import TuningBudget, tune
from repro_torch.fleet.workload import Trace, Workload

_MIN_RETUNE_BINS = 4        # no point re-tuning with nothing left to run
_MAX_CONSULT_CANDIDATES = 5  # active + interp + top corner winners; keeps
                             # an oracle consult well under a re-tune's cost


@dataclass(frozen=True)
class ControlEvent:
    """One timeline entry of a closed-loop run."""
    t_bin: int
    kind: str               # world-change | drift-alarm | rescope |
    #                         oracle-hit | oracle-miss | retune | swap
    detail: dict = field(default_factory=dict)

    def line(self) -> str:
        parts = ", ".join(f"{k}={v}" for k, v in self.detail.items())
        return f"bin {self.t_bin:>5}: {self.kind:<12} {parts}"


@dataclass
class ControlResult:
    """Outcome of one closed-loop run: the single continuous trace plus the
    controller's decision record."""
    sim: SimResult
    events: list
    n_alarms: int
    n_swaps: int
    incumbent_params: dict
    active_params: dict      # params serving at end of trace
    est_factor: float        # last degradation estimate (1.0: never alarmed)
    retunes: tuple = ()      # TuningReport per drift response
    rescopes: tuple = ()     # Recommendation per drift response
    oracle_hits: int = 0     # drift responses answered by the oracle
    oracle_misses: int = 0   # oracle refusals that fell back to re-tune
    oracle_answers: tuple = ()   # OracleAnswer per consultation

    @property
    def swapped(self) -> bool:
        return self.n_swaps > 0

    def timeline(self) -> str:
        return "\n".join(e.line() for e in self.events) or "(quiet run)"


class ClosedLoopController:
    """Drift-triggered re-scope + warm re-tune + mid-trace policy hot-swap.

    ``scenario`` is the tuning recipe the incumbent came from (policy
    family, context rows/constraint for re-scoping, Monte Carlo workload
    for re-tuning, backend and device); ``incumbent`` is its ``TuningReport``
    — the currently-deployed config and the warm-start seed for drift
    responses. The default probe and every re-tune run on the scenario's
    ``device``.

    ``segment_bins`` sets the control cadence (the probe needs at least its
    ``min_alarm_bins`` per window to alarm); ``cooldown_segments`` holds
    checks after a response while the re-fitted envelope settles;
    ``min_improvement`` is the score margin ($/hr-equivalent) a re-tuned
    winner must clear before the controller swaps it in. Scheduling
    discipline is pinned for the whole trace (serve-order tables are
    per-run static), so a ``discipline`` dim in a re-tuned winner is
    ignored at swap time.

    ``oracle`` (optional) is a :class:`~repro_torch.fleet.oracle.ScopingOracle`
    (or a bare :class:`~repro_torch.fleet.oracle.OracleTable`) consulted *before*
    re-tuning on every drift alarm: a hit replaces the warm re-tune's
    simulation budget with one paired three-candidate evaluation, a miss
    (refusal) falls back to the re-tune unchanged.
    """

    def __init__(self, scenario: TuningScenario, incumbent, *,
                 probe: DriftProbe = None, segment_bins: int = 45,
                 cooldown_segments: int = 1,
                 retune_budget: TuningBudget = None,
                 objective: Objective = None,
                 min_improvement: float = 0.0, retune_seed: int = 1,
                 retune_jitter: float = 0.35, oracle=None):
        if int(segment_bins) < 1:
            raise ValueError("segment_bins must be >= 1")
        self.scenario = scenario
        self.incumbent = incumbent
        self.incumbent_params = dict(incumbent.winner.params)
        self._probe0 = (probe if probe is not None
                        else DriftProbe(device=scenario.device))
        self.segment_bins = int(segment_bins)
        self.cooldown_segments = int(cooldown_segments)
        self.retune_budget = retune_budget or TuningBudget(n_candidates=12,
                                                           init_seeds=2)
        self.objective = objective or incumbent.objective
        self.min_improvement = float(min_improvement)
        self.retune_seed = int(retune_seed)
        # wider than tune()'s default: a drift response must be able to
        # leave the incumbent's neighborhood (the degraded world may need
        # several times the nominal fleet), while the anchors still keep
        # the incumbent region covered
        self.retune_jitter = float(retune_jitter)
        if oracle is not None and not hasattr(oracle, "query"):
            from repro_torch.fleet.oracle import ScopingOracle
            oracle = ScopingOracle(oracle)
        self.oracle = oracle

    # ---- observe/decide helpers --------------------------------------------

    def _fresh_probe(self) -> DriftProbe:
        return replace(self._probe0, model=None, sigma=None, mu=None)

    def _capacity_ratio(self, observed, reference, t0: int, t1: int,
                        ref_off: int) -> float:
        """Degradation estimate from busy-time efficiency — units served per
        replica-busy-second — observed window over the reference's matching
        bins. Sojourn-based estimates saturate once a backlog forms
        (queueing delay swamps service time and pegs any ratio at its
        clip); serving efficiency stays intrinsic to the node even when
        the fleet is drowning. The reference is the *current* model's
        predicted telemetry, so the absolute degradation estimate compounds
        this ratio onto the factor already modeled — an over-estimate
        self-corrects at the next alarm instead of resetting to nominal."""
        def eff(res, a, b):
            served = np.asarray(res.served, float)[:, a:b].sum()
            busy = (np.asarray(res.utilization, float)
                    * np.asarray(res.replicas, float))[:, a:b].sum()
            return served / busy if busy > 0 else 0.0
        e_obs = eff(observed, t0, t1)
        e_ref = eff(reference, t0 - ref_off, t1 - ref_off)
        if e_obs <= 0 or e_ref <= 0:
            return 1.0
        return float(np.clip(e_ref / e_obs, 0.1, 10.0))

    def _rescope(self, factor: float):
        """Re-run the analytic shape recommendation with every roofline term
        inflated by the degradation estimate. ``None`` when the scenario
        context carries no scoping rows."""
        rows = self.scenario.context.get("rows")
        constraint = self.scenario.context.get("constraint")
        if not rows or constraint is None:
            return None
        inflated = [
            replace(r, terms=RooflineTerms(r.terms.t_compute * factor,
                                           r.terms.t_memory * factor,
                                           r.terms.t_collective * factor))
            if r.terms is not None else r for r in rows]
        rec = recommend(inflated, constraint)
        telemetry.event("control_rescope", factor=factor,
                        shape=rec.shape.name if rec.shape else None,
                        feasible=rec.shape is not None)
        return rec

    def _tail_scenario(self, t1: int, factor: float) -> TuningScenario:
        scen = self.scenario
        return TuningScenario(
            name=f"{scen.name}/retune@{t1}",
            workload=tail_workload(scen.workload, t1),
            fleet=degrade_fleet(scen.fleet, factor),
            policy_cls=scen.policy_cls, context=scen.context,
            discipline=scen.discipline, max_queue=scen.max_queue,
            cold_start_seed=scen.cold_start_seed,
            build_policy=scen.build_policy, backend=scen.backend,
            n_substeps=scen.n_substeps, preemptive=scen.preemptive,
            device=scen.device)

    def _retune(self, t1: int, factor: float, warm_report, active: dict,
                round_i: int):
        """Budgeted warm re-tune over the remaining workload under the
        degraded service model; the active config races as the baseline."""
        tail_scen = self._tail_scenario(t1, factor)
        report = tune(tail_scen, warm_report.space, self.objective,
                      self.retune_budget, seed=self.retune_seed + round_i,
                      warm_start=warm_report, warm_jitter=self.retune_jitter,
                      baseline=dict(active))
        inc, win = report.baseline.mean_score(), report.winner.mean_score()
        improved = (win < inc - self.min_improvement
                    and report.winner.params != active)
        return report, improved

    def _consult_oracle(self, t1: int, factor: float, workload,
                        active: dict):
        """Oracle-first drift response: featurize the remaining workload
        inflated by the degradation estimate, look it up, and on a hit
        confirm with ONE paired evaluation on the degraded tail — the
        active config, the oracle's interpolated answer, and the verbatim
        winners of the contributing grid corners, strongest weight first
        (interpolating autoscaler gains between corners can land between
        two basins; the corner winners are the sweep's actually-validated
        configs, and under a shape mismatch a lower-weight corner often
        generalizes where the nearest one does not). A handful of
        candidates instead of a re-tune's dozens, and the never-worse
        guarantee survives: the active config races in the same paired
        draws, so an oracle config only ships if it measurably wins there.
        Returns (answer, winning params or None, replicates spent)."""
        tail = tail_workload(workload, t1)
        ans = self.oracle.query(tail, rate_factor=factor)
        if not ans.ok:
            return ans, None, 0
        cands = [dict(active), dict(ans.params)]
        ranked = sorted(zip(ans.corner_weights, ans.corner_idx),
                        key=lambda t: -t[0])
        for _, ci in ranked:
            cell = self.oracle.table.cells.get(ci)
            if cell is None:
                continue
            p = dict(cell.winner)
            if p not in cands:
                cands.append(p)
            if len(cands) >= _MAX_CONSULT_CANDIDATES:
                break
        evs = evaluate_candidates(self._tail_scenario(t1, factor), cands,
                                  self.objective)
        best = min(range(1, len(evs)), key=lambda i: evs[i].mean_score())
        improved = (evs[best].mean_score()
                    < evs[0].mean_score() - self.min_improvement
                    and cands[best] != cands[0])
        sims = len(cands) * evs[0].n_seeds
        return ans, (cands[best] if improved else None), sims

    def _reference_run(self, workload, fleet, params: dict,
                       discipline) -> SimResult:
        """Model-predicted telemetry: the probe's baseline must come from the
        same segmented engine as the live run (the coarse core defines
        utilization differently, which would read as instant drift)."""
        scen = self.scenario
        sim = SegmentedSimulation(
            workload, fleet, scen.make_policy(params),
            discipline=discipline, max_queue=scen.max_queue,
            cold_start_seed=scen.cold_start_seed,
            n_substeps=scen.n_substeps, preemptive=scen.preemptive)
        return sim.run_until(sim.n_bins).result()

    # ---- the loop ----------------------------------------------------------

    def run(self, case: DriftCase = None, *, workload=None,
            inject: dict = None) -> ControlResult:
        """Run one closed-loop trace. Pass a :class:`DriftCase` (live
        workload + scheduled world-side fleet swaps), or ``workload`` with an
        optional ``inject`` map ``{t_bin: FleetConfig | factor}`` (float
        factors degrade the nominal fleet). Defaults to the tuning
        scenario's own workload on the nominal fleet — a quiet run the
        controller should ride out without a single alarm."""
        scen = self.scenario
        if case is not None:
            if workload is not None or inject is not None:
                raise ValueError("pass a DriftCase or workload/inject, "
                                 "not both")
            workload, inject, fleet0 = (case.workload, dict(case.inject),
                                        case.fleet)
        else:
            workload = scen.workload if workload is None else workload
            inject = dict(inject or {})
            _, _, fleet0 = scen.split_params(self.incumbent_params)
        if isinstance(workload, Trace):
            workload = Workload.from_trace(workload,
                                           float(scen.context["slo_s"]))
        if workload.n_bins != scen.workload.n_bins:
            raise ValueError(
                f"live workload has {workload.n_bins} bins but the tuning "
                f"scenario has {scen.workload.n_bins}; re-tune windows "
                "must align bin-for-bin")
        inject = {int(t): (degrade_fleet(fleet0, float(f))
                           if isinstance(f, (int, float)) else f)
                  for t, f in inject.items()}
        _, discipline, _ = scen.split_params(self.incumbent_params)

        sim = SegmentedSimulation(
            workload, fleet0, scen.make_policy(self.incumbent_params),
            discipline=discipline, max_queue=scen.max_queue,
            cold_start_seed=scen.cold_start_seed,
            n_substeps=scen.n_substeps, preemptive=scen.preemptive)
        T = sim.n_bins

        probe = self._fresh_probe()
        base = self._reference_run(workload, fleet0, self.incumbent_params,
                                   discipline)
        probe.fit(base)
        ref_res, ref_off = base, 0

        events, retunes, rescopes = [], [], []
        oracle_answers = []
        n_alarms = n_swaps = cooldown = 0
        oracle_hits = oracle_misses = 0
        est_factor = 1.0        # degradation the controller currently models
        warm_report = self.incumbent
        active = dict(self.incumbent_params)

        with telemetry.span("control.run", scenario=scen.name, n_bins=T):
            t = 0
            while t < T:
                t1 = min(t + self.segment_bins, T)
                for tb in sorted(inject):
                    if t < tb < t1:
                        t1 = tb        # land world changes exactly on a
                        break          # boundary; the controller can't see
                #                        this, only its telemetry
                with telemetry.span("control.segment", t0=t, t1=t1):
                    sim.run_until(t1)
                if t1 in inject:
                    sim.swap(fleet=inject.pop(t1))
                    events.append(ControlEvent(t1, "world-change", {}))
                part = sim.partial_result()
                window = telemetry_matrix(part, probe.signals)[t:t1]
                if cooldown > 0:
                    cooldown -= 1
                    t = t1
                    continue
                rep = probe.check(window)
                if not rep.drifted:
                    t = t1
                    continue

                n_alarms += 1
                telemetry.counter("fleet_control_alarms_total")
                ratio = self._capacity_ratio(part, ref_res, t, t1, ref_off)
                est_factor = max(est_factor * ratio, 1.0)
                events.append(ControlEvent(t1, "drift-alarm", {
                    "alarm_bins": rep.alarm_bins, "n_bins": rep.n_bins,
                    "est_factor": round(est_factor, 3)}))
                rec = self._rescope(est_factor)
                if rec is not None:
                    rescopes.append(rec)
                    events.append(ControlEvent(t1, "rescope", {
                        "shape": rec.shape.name if rec.shape else None,
                        "feasible": rec.shape is not None}))
                if T - t1 < _MIN_RETUNE_BINS:
                    t = t1
                    continue
                new_params, report = None, None
                answered = False
                if self.oracle is not None:
                    with telemetry.span("control.oracle", t_bin=t1,
                                        factor=est_factor):
                        ans, chosen, eval_sims = self._consult_oracle(
                            t1, est_factor, workload, active)
                    oracle_answers.append(ans)
                    if ans.ok:
                        oracle_hits += 1
                        answered = True
                        telemetry.counter("fleet_control_oracle_hits_total")
                        events.append(ControlEvent(t1, "oracle-hit", {
                            "params": dict(ans.params),
                            "cell": ans.cell_idx,
                            "latency_us": round(ans.latency_us, 1),
                            "eval_sims": eval_sims,
                            "improved": chosen is not None}))
                        if chosen is not None:
                            new_params = dict(chosen)
                    else:
                        oracle_misses += 1
                        telemetry.counter(
                            "fleet_control_oracle_misses_total")
                        events.append(ControlEvent(t1, "oracle-miss", {
                            "reason": ans.reason}))
                if not answered:
                    with telemetry.span("control.retune", t_bin=t1,
                                        factor=est_factor):
                        report, improved = self._retune(
                            t1, est_factor, warm_report, active,
                            len(retunes))
                    retunes.append(report)
                    events.append(ControlEvent(t1, "retune", {
                        "winner": report.winner.params,
                        "incumbent_score":
                            round(report.baseline.mean_score(), 3),
                        "winner_score":
                            round(report.winner.mean_score(), 3),
                        "sims": report.sims_used}))
                    if improved:
                        new_params = dict(report.winner.params)
                if new_params is not None:
                    sim.swap(policy=scen.make_policy(new_params))
                    active = new_params
                    if report is not None:
                        warm_report = report
                    n_swaps += 1
                    telemetry.counter("fleet_control_swaps_total")
                    events.append(ControlEvent(t1, "swap",
                                               {"params": active}))
                # re-baseline the envelope on model-predicted telemetry for
                # the (possibly swapped) config under the estimated
                # degradation, then hold a cooldown while it settles
                ref = self._reference_run(
                    tail_workload(workload, t1),
                    degrade_fleet(fleet0, est_factor), active, discipline)
                probe = self._fresh_probe().fit(ref)
                ref_res, ref_off = ref, t1
                cooldown = self.cooldown_segments
                t = t1

        return ControlResult(
            sim=sim.result(), events=events, n_alarms=n_alarms,
            n_swaps=n_swaps, incumbent_params=dict(self.incumbent_params),
            active_params=active, est_factor=est_factor,
            retunes=tuple(retunes), rescopes=tuple(rescopes),
            oracle_hits=oracle_hits, oracle_misses=oracle_misses,
            oracle_answers=tuple(oracle_answers))
