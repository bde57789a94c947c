"""Vectorized candidate evaluation: configs x seeded trace replicates.

The scenario pre-samples ONE Monte Carlo workload tensor (n_seeds trace
replicates) and every candidate config is simulated against slices of that
same tensor. Candidates are therefore *paired* on identical arrival draws:
the difference between two candidates' per-seed scores is free of the
arrival-sampling variance a naive sweep (fresh traces per candidate) pays —
the classic common-random-numbers variance reduction, and what lets the
racing loop compare candidates on very few replicates.

Per candidate the evaluator returns per-seed dollar cost, worst-class SLO
attainment and drop rate (the simulator is already seed-vectorized, so one
``simulate_fleet`` call covers a whole seed slice), the pooled per-request
p99, and across-seed confidence intervals.

A scenario may also carry a *portfolio* of traces (a sequence of Workloads
sharing dt/bins/seeds/classes). The compiled backend folds the portfolio
into the same single dispatch — members stack along the seed axis, so a
racing round is still ONE candidate x (seed x trace) lattice — and
per-trace scores reduce to a robust per-seed score via a pluggable
objective (``worst_case`` / ``cvar(alpha)`` / ``mean``) that racing and
SPRT culling consume directly. A winner under ``worst_case`` is the config
whose *worst* trace is cheapest-feasible: robust, not scenario-overfit.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

from repro_torch.core.cost_model import dollar_cost
from repro_torch.fleet import telemetry
from repro_torch.fleet.report import weighted_percentile
from repro_torch.fleet.simulator import (FleetConfig, SimResult,
                                         draw_cold_start_delays, simulate_fleet)
from repro_torch.fleet.traces import Trace
from repro_torch.fleet.workload import Workload

_Z95 = 1.959963984540054


@dataclass(frozen=True)
class Objective:
    """Scalarization of (cost, SLO attainment): dollars per hour plus a steep
    penalty per unit of worst-class attainment shortfall below the bar. The
    penalty converts "meet the SLO" into a soft constraint the tuner can
    race on — a config missing the bar by 1% pays ``penalty_usd_per_hour/100``
    extra $/hr, dwarfing any honest capacity saving."""
    min_attainment: float = 0.99
    penalty_usd_per_hour: float = 2000.0

    def score(self, cost_usd_hr, attainment):
        """Per-seed scalar score (lower is better); inputs broadcast."""
        shortfall = np.maximum(self.min_attainment - np.asarray(attainment),
                               0.0)
        return np.asarray(cost_usd_hr) + self.penalty_usd_per_hour * shortfall

    def to_json(self) -> dict:
        return {"min_attainment": self.min_attainment,
                "penalty_usd_per_hour": self.penalty_usd_per_hour}

    @staticmethod
    def from_json(d: dict) -> "Objective":
        return Objective(min_attainment=float(d["min_attainment"]),
                         penalty_usd_per_hour=float(d["penalty_usd_per_hour"]))


_CVAR_RE = re.compile(r"cvar\(\s*([0-9.eE+-]+)\s*\)")


def robust_m(spec: str, n_traces: int) -> int:
    """How many worst traces the robust objective averages over: 1 for
    ``worst_case``, all for ``mean``, ``ceil(alpha * K)`` (clipped to
    [1, K]) for ``cvar(alpha)`` — the discrete CVaR over K equally likely
    trace outcomes. Raises on an unknown spec (validated at scenario
    construction, so a typo fails before any simulation is spent)."""
    K = int(n_traces)
    s = str(spec).strip().lower()
    if s == "worst_case":
        return 1
    if s == "mean":
        return K
    m = _CVAR_RE.fullmatch(s)
    if m:
        alpha = float(m.group(1))
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"cvar alpha must be in (0, 1], got {alpha}")
        return int(np.clip(int(np.ceil(alpha * K)), 1, K))
    raise ValueError(f"unknown robust objective {spec!r}; expected "
                     "'worst_case', 'mean' or 'cvar(alpha)'")


def robust_weights(scores: np.ndarray, spec: str) -> np.ndarray:
    """Per-seed trace-mix weights for the robust reduction: for each seed
    column of the (K, S) per-trace score matrix, uniform mass ``1/m`` on
    the ``m = robust_m(spec, K)`` worst (highest-score) traces and 0
    elsewhere. ``worst_case`` (m=1) reduces to the exact worst-trace row,
    ``mean`` (m=K) to the plain trace average, ``cvar(alpha)`` to the
    discrete expected-shortfall in between. Ties break by trace order
    (stable sort), so the reduced *score* is deterministic and invariant
    under trace permutation."""
    scores = np.asarray(scores, float)
    K, S = scores.shape
    m = robust_m(spec, K)
    w = np.zeros((K, S))
    worst = np.argsort(-scores, axis=0, kind="stable")[:m]
    np.put_along_axis(w, worst, 1.0 / m, axis=0)
    return w


@dataclass
class CandidateEval:
    """One candidate's evidence so far (arrays grow as racing adds seeds)."""
    params: dict
    cost_usd_hr: np.ndarray          # (n_seeds_seen,)
    attainment: np.ndarray           # (n_seeds_seen,) worst-class
    drop_rate: np.ndarray            # (n_seeds_seen,)
    score: np.ndarray                # (n_seeds_seen,) objective scalarization
    sojourns: list = field(repr=False, default_factory=list)  # (vals, wts)
    n_rounds: int = 0                # racing rounds survived
    # portfolio evidence: the raw per-trace CandidateEvals the robust
    # reduction folded (None for single-trace scenarios)
    per_trace: Optional[list] = field(repr=False, default=None)

    @property
    def n_seeds(self) -> int:
        return len(self.score)

    def mean_cost(self) -> float:
        return float(self.cost_usd_hr.mean())

    def mean_attainment(self) -> float:
        return float(self.attainment.mean())

    def mean_drop_rate(self) -> float:
        return float(self.drop_rate.mean())

    def mean_score(self) -> float:
        return float(self.score.mean())

    def ci(self, arr: np.ndarray) -> float:
        """95% half-width of the mean (0 with a single replicate)."""
        if len(arr) < 2:
            return 0.0
        return float(_Z95 * arr.std(ddof=1) / np.sqrt(len(arr)))

    def cost_ci(self) -> float:
        return self.ci(self.cost_usd_hr)

    def attainment_ci(self) -> float:
        return self.ci(self.attainment)

    def score_ci(self) -> float:
        return self.ci(self.score)

    def p99_s(self) -> float:
        """Pooled exact per-request p99 over every seed seen."""
        if not self.sojourns:
            return float("nan")
        vals = np.concatenate([v for v, _ in self.sojourns])
        wts = np.concatenate([w for _, w in self.sojourns])
        return weighted_percentile(vals, wts, 99)

    def worst_trace_score(self) -> float:
        """Mean score on this candidate's worst portfolio trace (its own
        mean score for single-trace evidence) — the robustness yardstick:
        a scenario-overfit winner looks great on its tuning trace and falls
        over here."""
        if not self.per_trace:
            return self.mean_score()
        return max(ev.mean_score() for ev in self.per_trace)

    def worst_trace_attainment(self) -> float:
        """Mean worst-class attainment on the worst portfolio trace."""
        if not self.per_trace:
            return self.mean_attainment()
        return min(ev.mean_attainment() for ev in self.per_trace)

    def extend(self, other: "CandidateEval") -> None:
        """Append another seed slice's evidence (paired racing rounds)."""
        self.cost_usd_hr = np.concatenate([self.cost_usd_hr,
                                           other.cost_usd_hr])
        self.attainment = np.concatenate([self.attainment, other.attainment])
        self.drop_rate = np.concatenate([self.drop_rate, other.drop_rate])
        self.score = np.concatenate([self.score, other.score])
        self.sojourns.extend(other.sojourns)
        if self.per_trace and other.per_trace:
            for mine, new in zip(self.per_trace, other.per_trace):
                mine.extend(new)

    def to_json(self, include_sojourns: bool = False) -> dict:
        """Plain-JSON form of this candidate's evidence. Per-request sojourn
        samples are dropped by default (they dominate the payload and only
        feed ``p99_s``); pass ``include_sojourns=True`` to keep them."""
        out = {"params": dict(self.params),
               "cost_usd_hr": [float(v) for v in self.cost_usd_hr],
               "attainment": [float(v) for v in self.attainment],
               "drop_rate": [float(v) for v in self.drop_rate],
               "score": [float(v) for v in self.score],
               "n_rounds": int(self.n_rounds)}
        if include_sojourns:
            out["sojourns"] = [([float(x) for x in v], [float(x) for x in w])
                               for v, w in self.sojourns]
        if self.per_trace:
            out["per_trace"] = [ev.to_json(include_sojourns=include_sojourns)
                                for ev in self.per_trace]
        return out

    @staticmethod
    def from_json(d: dict) -> "CandidateEval":
        sojourns = [(np.asarray(v, float), np.asarray(w, float))
                    for v, w in d.get("sojourns", [])]
        per_trace = [CandidateEval.from_json(e)
                     for e in d.get("per_trace", [])] or None
        return CandidateEval(
            params=dict(d["params"]),
            cost_usd_hr=np.asarray(d["cost_usd_hr"], float),
            attainment=np.asarray(d["attainment"], float),
            drop_rate=np.asarray(d["drop_rate"], float),
            score=np.asarray(d["score"], float),
            sojourns=sojourns, n_rounds=int(d.get("n_rounds", 0)),
            per_trace=per_trace)


def _slice_trace(tr: Trace, s0: int, s1: int) -> Trace:
    return Trace(tr.name, tr.dt_s, tr.rate, tr.arrivals[s0:s1])


def _slice_workload(wl: Workload, s0: int, s1: int) -> Workload:
    return Workload(wl.name, wl.classes,
                    tuple(_slice_trace(tr, s0, s1) for tr in wl.traces))


@dataclass
class TuningScenario:
    """Everything ``tune()`` needs to score a candidate config:

    * ``workload``  — the shared Monte Carlo trace tensor (a ``Workload``, or
      a bare ``Trace`` + ``slo_s``); its seed axis is the replicate budget.
      A *sequence* of Workloads/Traces declares a portfolio: every candidate
      is scored on every member (flash-crowd + diurnal + replay + ...) and
      per-trace scores reduce via ``robust`` before racing sees them. Members
      must share dt/bins/seeds and request classes; member 0 is *primary* —
      it pins the initial provisioning every member starts from (one fleet,
      several demand futures).
    * ``fleet``     — the fleet template (``quota:<pool>`` dims override each
      pool's ``max_replicas`` per candidate).
    * ``policy_cls`` + ``context`` — the policy family under tuning;
      candidates are built with ``policy_cls.from_params(params, **context)``.
    * ``discipline``/``max_queue``/``cold_start_seed`` — simulation fixtures
      (a ``discipline`` dim in the space overrides the fixture).
    * ``backend`` — the simulator implementation candidates are scored on:
      ``"numpy"`` (reference), ``"torch"`` (compiled; a whole racing round is
      one candidate x seed x trace batch, ``repro_torch.fleet.torchsim``), or
      ``"auto"`` (the default: compiled when the policy family has a kernel,
      numpy otherwise — every built-in family has one, and both paths agree
      to float rounding). ``"auto"`` never looks at which devices exist.
    * ``device`` — where the compiled backend runs: ``None`` (the default)
      means the card, raising when there is none; ``"cpu"`` the CPU. The
      numpy backend ignores it.
    * ``n_substeps``/``preemptive`` — simulator fidelity knobs forwarded to
      every ``simulate_fleet`` call (see the simulator docstring); the
      defaults keep the coarse bin-granular core.
    * ``robust`` — the per-seed trace reduction: ``"worst_case"`` (default),
      ``"mean"``, or ``"cvar(alpha)"`` (see ``robust_weights``). Ignored for
      single-trace scenarios, where scoring is unchanged.
    * ``tile``   — candidate tile width for the compiled backend: slates
      wider than the (pow2-rounded) tile stream through fixed-shape chunks
      sharing one dispatch signature, so thousands of LHS candidates cost one
      cold dispatch plus warm repeats (``None`` disables tiling).
    """
    name: str
    workload: Workload
    fleet: FleetConfig
    policy_cls: type
    context: dict = field(default_factory=dict)
    discipline: str = "fifo"
    max_queue: Optional[float] = None
    cold_start_seed: int = 0
    build_policy: Callable = None    # override: params -> Policy
    backend: str = "auto"
    n_substeps: int = 1
    preemptive: bool = False
    robust: str = "worst_case"
    tile: Optional[int] = 256
    device: object = None

    def __post_init__(self):
        members = self.workload
        if isinstance(members, (Workload, Trace)):
            members = (members,)
        norm = []
        for m in members:
            if isinstance(m, Trace):
                slo = self.context.get("slo_s")
                if slo is None:
                    raise ValueError("a bare Trace workload needs context"
                                     "['slo_s'] for its request class")
                m = Workload.from_trace(m, float(slo))
            norm.append(m)
        if not norm:
            raise ValueError("empty trace portfolio")
        first = norm[0]
        for m in norm[1:]:
            if (m.dt_s != first.dt_s or m.n_bins != first.n_bins
                    or m.n_seeds != first.n_seeds):
                raise ValueError(
                    f"portfolio member {m.name!r} has (dt={m.dt_s}, "
                    f"bins={m.n_bins}, seeds={m.n_seeds}); members must "
                    f"match the primary's (dt={first.dt_s}, "
                    f"bins={first.n_bins}, seeds={first.n_seeds})")
            if m.classes != first.classes:
                raise ValueError(
                    f"portfolio member {m.name!r} declares different "
                    "request classes than the primary; the candidate's "
                    "policy/tables are shared across members")
        self.portfolio = tuple(norm)
        self.workload = first
        robust_m(self.robust, len(norm))   # fail on a typo before any sims
        self._cs_delay = False       # lazy cold-start jitter tensor cache
        self._tables = {}            # per-discipline cohort_tables cache
        self._batch_windows = None   # sticky kernel ring-buffer sizes

    @property
    def n_seeds(self) -> int:
        return self.workload.n_seeds

    @property
    def n_traces(self) -> int:
        return len(self.portfolio)

    def cold_start_delays(self):
        """The (n_traces * n_seeds, n_bins, n_pools) spin-up jitter tensor,
        drawn ONCE per scenario and sliced per racing round — every candidate
        sees identical draws anyway (they are keyed by absolute row identity
        ``member * n_seeds + seed``), so re-drawing them per
        ``simulate_fleet`` call was pure per-candidate RNG overhead. ``None``
        when no pool jitters."""
        if self._cs_delay is False:
            rows = self.n_traces * self.n_seeds
            self._cs_delay = draw_cold_start_delays(
                self.fleet.pools, rows, self.workload.n_bins,
                self.workload.dt_s, self.cold_start_seed, np.arange(rows))
        return self._cs_delay

    def _cs_rows(self, s0: int, s1: int, member: int = 0):
        cs = self.cold_start_delays()
        if cs is None:
            return None
        base = member * self.n_seeds
        return cs[base + s0:base + s1]

    def cohort_tables_for(self, discipline):
        """Cached static serve-order tables for the compiled backend."""
        from repro_torch.fleet.discipline import cohort_tables
        key = discipline if isinstance(discipline, str) else id(discipline)
        tabs = self._tables.get(key)
        if tabs is None:
            tabs = cohort_tables(discipline, self.workload.classes,
                                 self.workload.n_bins, self.workload.dt_s)
            self._tables[key] = tabs
        return tabs

    def split_params(self, params: dict):
        """(policy_params, discipline, fleet) for one candidate — the
        cross-cutting ``discipline``/``quota:*`` dims are simulation-level,
        everything else belongs to the policy constructor."""
        policy_params = {k: v for k, v in params.items()
                         if k != "discipline" and not k.startswith("quota:")}
        discipline = params.get("discipline", self.discipline)
        fleet = self.fleet
        quotas = {k[len("quota:"):]: int(v) for k, v in params.items()
                  if k.startswith("quota:")}
        if quotas:
            pools = tuple(
                replace(p, max_replicas=quotas[p.label],
                        min_replicas=min(p.min_replicas, quotas[p.label]))
                if p.label in quotas else p for p in fleet.pools)
            fleet = FleetConfig(pools, max_queue=fleet.max_queue)
        return policy_params, discipline, fleet

    def make_policy(self, params: dict):
        policy_params, _, fleet = self.split_params(params)
        if self.build_policy is not None:
            return self.build_policy(policy_params)
        ctx = dict(self.context)
        ctx.pop("slo_s", None)
        if "fleet" in ctx or getattr(self.policy_cls, "per_pool", False):
            ctx["fleet"] = fleet
        return self.policy_cls.from_params(policy_params, **ctx)

    def _member_fleet(self, fleet: FleetConfig, member: int) -> FleetConfig:
        """Portfolio members share the PRIMARY member's initial provisioning:
        the portfolio races one starting fleet against several demand
        futures, so member ``k > 0`` gets explicit ``initial_replicas``
        pinned from member 0's opening rate — exactly what the batched
        dispatch does, whose ``init_ready`` is per-candidate, not per-row."""
        if member == 0:
            return fleet
        from repro_torch.fleet.simulator import _initial_replicas
        rate0 = float(self.workload.total_trace().rate[0])
        first = fleet.drain_order()[0]
        pools = tuple(
            replace(pc, initial_replicas=_initial_replicas(
                pc, rate0, p == first))
            for p, pc in enumerate(fleet.pools))
        return FleetConfig(pools, max_queue=fleet.max_queue)

    def simulate(self, params: dict, s0: int, s1: int,
                 backend: str = None, member: int = 0) -> SimResult:
        """Run one candidate against the shared seed slice [s0, s1) of
        portfolio member ``member``. ``seed_indices`` pins each row's
        cold-start jitter substream to its absolute replicate id
        ``member * n_seeds + seed``, so racing's incremental slices see
        exactly the draws a single full-budget evaluation would (the
        scenario hands the pre-drawn tensor rows straight to the
        simulator)."""
        _, discipline, fleet = self.split_params(params)
        base = member * self.n_seeds
        return simulate_fleet(
            _slice_workload(self.portfolio[member], s0, s1),
            self._member_fleet(fleet, member),
            self.make_policy(params), discipline=discipline,
            max_queue=self.max_queue, cold_start_seed=self.cold_start_seed,
            seed_indices=np.arange(base + s0, base + s1),
            cold_start_delays=self._cs_rows(s0, s1, member),
            backend=self.backend if backend is None else backend,
            n_substeps=self.n_substeps, preemptive=self.preemptive,
            device=self.device)


def per_seed_metrics(sim: SimResult):
    """(cost $/hr, worst-class attainment, drop rate), each (n_seeds,), from
    one seed-vectorized simulation — the per-seed analogues of
    ``report.summarize``'s scalars (same conventions: drops count against
    attainment, the unresolved terminal backlog counts for neither side)."""
    S = sim.arrivals.shape[0]
    usd = np.zeros(S)
    for p, pc in enumerate(sim.fleet.pools):
        bins = sim.pool_billed[:, :, p].sum(axis=1)
        usd += dollar_cost(sim.dt_s, bins, pc.service.shape.chips,
                           pc.service.shape.hw)
    cost_hr = usd / max(sim.trace.duration_s / 3600.0, 1e-12)

    arrived_c = (sim.class_admitted + sim.class_dropped).sum(axis=1)
    completed_c = arrived_c - sim.class_queue[:, -1, :]
    ok_c = sim.class_ok.sum(axis=1)
    att_c = np.divide(ok_c, completed_c, out=np.ones_like(ok_c),
                      where=completed_c > 0)
    worst_att = att_c.min(axis=1)

    arrived = sim.arrivals.sum(axis=1)
    drop = sim.dropped.sum(axis=1) / np.maximum(arrived, 1.0)
    return cost_hr, worst_att, drop


def _eval_from_sim(params: dict, sim: SimResult,
                   objective: Objective) -> CandidateEval:
    cost_hr, att, drop = per_seed_metrics(sim)
    return CandidateEval(
        params=dict(params), cost_usd_hr=cost_hr, attainment=att,
        drop_rate=drop, score=np.asarray(objective.score(cost_hr, att)),
        sojourns=[(sim.sojourn_values, sim.sojourn_weights)])


def _reduce_portfolio(per_trace: list, robust: str) -> CandidateEval:
    """Fold K per-trace evals into one robust eval. Per-seed weights come
    from ``robust_weights`` over the (K, S) score matrix; the reduced score
    is the weighted trace mix (for ``worst_case``, exactly the worst
    trace's per-seed score), cost/attainment/drop use the SAME weights (the
    reported cost is the cost *on the traces that set the score*), sojourns
    pool across traces, and the raw per-trace evidence rides along in
    ``per_trace`` for overfit diagnostics."""
    scores = np.stack([ev.score for ev in per_trace])      # (K, S)
    w = robust_weights(scores, robust)

    def mix(key):
        return (w * np.stack([getattr(ev, key)
                              for ev in per_trace])).sum(axis=0)

    return CandidateEval(
        params=dict(per_trace[0].params),
        cost_usd_hr=mix("cost_usd_hr"), attainment=mix("attainment"),
        drop_rate=mix("drop_rate"), score=(w * scores).sum(axis=0),
        sojourns=[sj for ev in per_trace for sj in ev.sojourns],
        per_trace=list(per_trace))


def _batched_dynamics(scenario: TuningScenario, candidates: list,
                      s0: int, s1: int):
    """Run the whole candidate slate through ONE compiled dispatch chain:
    stack every candidate's kernel params, discipline tables and quota
    bounds, fold the trace portfolio along the seed axis (rows
    ``member * slice + seed``, so K traces ride the same candidate x row
    lattice with no per-trace Python loop), and dispatch. Returns
    ``(out, ctx)`` with the raw dynamics outputs plus everything the host
    needs to assemble per-candidate results, or ``None`` when the slate
    cannot batch (custom ``build_policy``, a family without a kernel). The
    inputs come from ``torchsim.slate_arguments``, the one builder of
    ``run_dynamics`` inputs."""
    if scenario.build_policy is not None:
        return None
    from repro_torch.fleet import torchsim

    members = [_slice_workload(w, s0, s1) for w in scenario.portfolio]
    wl = members[0]
    policies, discs, fleets = [], [], []
    for params in candidates:
        _, disc, fleet = scenario.split_params(params)
        policies.append(scenario.make_policy(params))
        discs.append(disc)
        fleets.append(fleet)
    # same contract as simulate_fleet: a single-target policy cannot drive a
    # multi-pool fleet (broadcasting its target across pools would score a
    # semantically meaningless config instead of failing)
    P = fleets[0].n_pools
    if P > 1 and not getattr(policies[0], "per_pool", False):
        raise ValueError(f"policy {policies[0].name!r} returns a single "
                         f"target; a {P}-pool fleet needs a per-pool policy "
                         "(e.g. HeterogeneousPredictivePolicy)")

    # ring-buffer sizes must be static across the batch AND sticky across
    # racing rounds (a shrinking round must reuse the dispatch signature)
    windows = torchsim.slate_windows(policies, scenario._batch_windows)
    scenario._batch_windows = windows
    if torchsim.slate_kernel(policies, fleets, wl.classes, windows) is None:
        return None
    if len(members) == 1:
        cs_rows = scenario._cs_rows(s0, s1)
    else:
        cs = scenario.cold_start_delays()
        S = scenario.n_seeds
        cs_rows = None if cs is None else np.concatenate(
            [cs[k * S + s0:k * S + s1] for k in range(len(members))], axis=0)
    template = fleets[0]
    kernel, kw = torchsim.slate_arguments(
        members, template, policies, fleets=fleets, disciplines=discs,
        max_queue=scenario.max_queue,
        cs_delay=cs_rows, windows=windows,
        tables_for=scenario.cohort_tables_for)
    out = torchsim.run_dynamics(
        kernel, **kw, n_substeps=scenario.n_substeps,
        preemptive=scenario.preemptive, tile=scenario.tile,
        device=scenario.device)
    ctx = {"members": members, "policies": policies, "discs": discs,
           "fleets": fleets, "order": template.drain_order(), "s": s1 - s0}
    return out, ctx


def _assemble_evals(scenario: TuningScenario, out: dict, ctx: dict,
                    candidates: list, objective: Objective,
                    slos: np.ndarray) -> list:
    """Finish each candidate's exact latency accounting on the host, one
    SimResult per (candidate, portfolio member) from its row block of the
    dispatch outputs, then reduce members via the scenario's robust
    objective (a single-trace scenario returns the plain eval — identical
    arrays and evidence to the pre-portfolio path)."""
    from repro_torch.fleet.discipline import get_discipline
    from repro_torch.fleet.simulator import _result_from_dynamics

    members, s = ctx["members"], ctx["s"]
    evals = []
    for i, params in enumerate(candidates):
        disc = get_discipline(ctx["discs"][i])
        per = []
        for k, wlk in enumerate(members):
            sim = _result_from_dynamics(
                wlk, ctx["fleets"][i], disc, ctx["policies"][i].name,
                ctx["order"], slos,
                {key: v[i, k * s:(k + 1) * s] for key, v in out.items()},
                n_substeps=scenario.n_substeps,
                preemptive=scenario.preemptive)
            per.append(_eval_from_sim(params, sim, objective))
        evals.append(per[0] if len(per) == 1
                     else _reduce_portfolio(per, scenario.robust))
    return evals


def _evaluate_batched(scenario: TuningScenario, candidates: list,
                      objective: Objective, s0: int, s1: int):
    """Score the whole candidate slate in ONE compiled dispatch chain (see
    ``_batched_dynamics``); ``None`` when the slate cannot batch."""
    got = _batched_dynamics(scenario, candidates, s0, s1)
    if got is None:
        return None
    out, ctx = got
    return _assemble_evals(scenario, out, ctx, candidates, objective,
                           ctx["members"][0].slos())


def evaluate_candidates_column(scenario: TuningScenario, candidates: list,
                               objective: Objective, slo_values,
                               s0: int = 0, s1: int = None):
    """Score one candidate slate for a whole column of SLO tiers with ONE
    compiled dispatch chain. Sound for single-class workloads only: with one
    request class the SLO never enters the dynamics — policies pop
    ``slo_s`` from their context, and every built-in kernel's SLO read is
    behind a ``n_classes > 1`` guard (``_queue_demand``'s short-circuit,
    the hetero kernel's critical-demand branch) — so tiers share bin-exact
    trajectories and only the host-side exact-latency accounting (which
    requests made their bar) differs. Returns a list of per-tier eval
    lists aligned with ``slo_values``, or ``None`` when the slate cannot
    batch (caller falls back to per-tier evaluation)."""
    s1 = scenario.n_seeds if s1 is None else s1
    if len(scenario.workload.classes) != 1:
        return None
    got = _batched_dynamics(scenario, candidates, s0, s1)
    if got is None:
        return None
    out, ctx = got
    return [_assemble_evals(scenario, out, ctx, candidates, objective,
                            np.array([float(slo)]))
            for slo in slo_values]


def evaluate_candidates(scenario: TuningScenario, candidates: list,
                        objective: Objective, s0: int = 0,
                        s1: int = None, backend: str = None) -> list:
    """Score every candidate on the shared seed slice [s0, s1); identical
    slices across candidates give the paired comparison racing relies on.

    On the numpy backend, one seed-vectorized ``simulate_fleet`` call per
    candidate per portfolio member covers the whole slice. On the torch
    backend the entire candidate slate — every portfolio member included —
    is scored in one candidate x (seed x trace) dispatch chain on the
    scenario's ``device``
    (``_evaluate_batched``); ``"auto"`` batches when the policy family has a
    compiled kernel and falls back to the numpy loop otherwise. ``backend``
    overrides the scenario's own setting. One "sim" is one
    (candidate, seed, trace) trajectory, whichever backend runs it."""
    s1 = scenario.n_seeds if s1 is None else s1
    if not 0 <= s0 < s1 <= scenario.n_seeds:
        raise ValueError(f"bad seed slice [{s0}, {s1}) for "
                         f"{scenario.n_seeds} replicates")
    if not candidates:
        return []
    backend = scenario.backend if backend is None else backend
    if backend not in ("numpy", "torch", "auto"):
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'numpy', 'torch' or 'auto'")
    telemetry.counter("tuning_sims_total",
                      len(candidates) * (s1 - s0) * scenario.n_traces,
                      backend=backend)
    if backend != "numpy":
        evals = _evaluate_batched(scenario, candidates, objective, s0, s1)
        if evals is not None:
            return evals
        if backend == "torch":
            raise ValueError(
                "backend='torch': this scenario cannot batch (custom "
                "build_policy or a policy family without a compiled "
                "kernel); use backend='auto' to fall back to numpy")
    out = []
    for params in candidates:
        per = [_eval_from_sim(
            params, scenario.simulate(params, s0, s1, backend="numpy",
                                      member=k), objective)
            for k in range(scenario.n_traces)]
        out.append(per[0] if len(per) == 1
                   else _reduce_portfolio(per, scenario.robust))
    return out
