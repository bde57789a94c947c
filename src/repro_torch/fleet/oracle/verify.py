"""Oracle verification: spot-check compiled answers against fresh simulation.

A lookup table is only as good as its sweep — so the verifier samples query
points inside the gridded region (off the grid points, where interpolation
actually happens), synthesizes a *fresh* canonical trace at each point with
seeds the builder never saw, simulates the oracle's answered config, and
compares the simulated cost/attainment against what the oracle predicted.
The report's error bounds are the oracle's trust certificate: the bench
gate pins them, and a drifted table (stale fleet menu, changed service
model) fails here before it mis-scopes anything in production.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from repro_torch.fleet.oracle.build import OracleTable, canonical_trace
from repro_torch.fleet.oracle.oracle import ScopingOracle
from repro_torch.fleet.tuning.evaluate import TuningScenario, evaluate_candidates
from repro_torch.fleet.workload import Workload

_LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class SpotCheck:
    """One sampled query vs its fresh simulation."""
    mean_rate: float
    burstiness: float
    slo_s: float
    params: dict
    predicted_cost: float
    simulated_cost: float
    predicted_attainment: float
    simulated_attainment: float
    exact: bool
    predicted_bound: float = float("nan")   # answer's cost_bound_usd_hr

    @property
    def cost_err(self) -> float:
        """Relative cost error |sim - predicted| / sim."""
        return abs(self.simulated_cost - self.predicted_cost) \
            / max(self.simulated_cost, 1e-12)

    @property
    def cost_overrun(self) -> float:
        """Relative amount the simulated cost exceeds the answer's upper
        bound (0 when within bound). The directional failure that matters:
        an oracle that *under*-promises is merely conservative, one whose
        bound is busted mis-scopes budgets."""
        if not np.isfinite(self.predicted_bound):
            return 0.0
        return max(0.0, self.simulated_cost - self.predicted_bound) \
            / max(self.predicted_bound, 1e-12)

    @property
    def attainment_err(self) -> float:
        return abs(self.simulated_attainment - self.predicted_attainment)


@dataclass
class VerificationReport:
    """Error bounds over the sampled spot-checks."""
    checks: list = field(default_factory=list)
    refused: int = 0

    @property
    def n(self) -> int:
        return len(self.checks)

    @property
    def max_cost_err(self) -> float:
        return max((c.cost_err for c in self.checks), default=float("nan"))

    @property
    def mean_cost_err(self) -> float:
        if not self.checks:
            return float("nan")
        return float(np.mean([c.cost_err for c in self.checks]))

    @property
    def max_cost_overrun(self) -> float:
        return max((c.cost_overrun for c in self.checks),
                   default=float("nan"))

    @property
    def max_attainment_err(self) -> float:
        return max((c.attainment_err for c in self.checks),
                   default=float("nan"))

    def ok(self, cost_tol: float = 0.25, attainment_tol: float = 0.05,
           overrun_tol: float = 0.05) -> bool:
        """Every spot-check within tolerance and none refused. The cost
        bound is gated tight (``overrun_tol``); the symmetric point error
        looser (``cost_tol``) — interpolating between cells whose winners
        differ overestimates cost, which is the safe direction."""
        return (self.n > 0 and self.refused == 0
                and self.max_cost_err <= cost_tol
                and self.max_cost_overrun <= overrun_tol
                and self.max_attainment_err <= attainment_tol)

    def to_json(self) -> dict:
        return {"n": self.n, "refused": self.refused,
                "max_cost_err": self.max_cost_err,
                "mean_cost_err": self.mean_cost_err,
                "max_cost_overrun": self.max_cost_overrun,
                "max_attainment_err": self.max_attainment_err,
                "checks": [{
                    "mean_rate": c.mean_rate, "burstiness": c.burstiness,
                    "slo_s": c.slo_s, "params": dict(c.params),
                    "predicted_cost": c.predicted_cost,
                    "predicted_bound": c.predicted_bound,
                    "simulated_cost": c.simulated_cost,
                    "predicted_attainment": c.predicted_attainment,
                    "simulated_attainment": c.simulated_attainment,
                    "exact": c.exact} for c in self.checks]}

    def summary(self) -> str:
        if not self.checks:
            return f"oracle verify: no checks ran ({self.refused} refused)"
        return (f"oracle verify: {self.n} spot-checks, cost error "
                f"mean {self.mean_cost_err * 100:.1f}% / "
                f"max {self.max_cost_err * 100:.1f}%, attainment error "
                f"max {self.max_attainment_err * 100:.2f}pp"
                + (f", {self.refused} refused" if self.refused else ""))


def _sample_points(table: OracleTable, n: int, seed: int) -> list:
    """n query points uniform over the hull in each axis's own scale —
    strictly interior (5%..95% of each span), so interpolation is exercised
    rather than the verbatim grid-point fast path."""
    g = table.grid
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(n):
        u = rng.uniform(0.05, 0.95, size=3)
        mr = g.mean_rates[0] * (g.mean_rates[-1] / g.mean_rates[0]) ** u[0]
        b = g.burstiness[0] + u[1] * (g.burstiness[-1] - g.burstiness[0])
        slo = g.slos[0] * (g.slos[-1] / g.slos[0]) ** u[2]
        pts.append((float(mr), float(b), float(slo)))
    return pts


def verify_oracle(table: OracleTable, fleet, policy_cls, *,
                  n_samples: int = 5, seed: int = 12345,
                  context: dict = None, discipline: str = "fifo",
                  max_queue: float = None, backend: str = "auto",
                  points: list = None, device=None) -> VerificationReport:
    """Spot-check ``n_samples`` interior query points of ``table`` against
    fresh simulation on ``fleet``.

    ``fleet``/``policy_cls``/``context`` must describe the same deployment
    the table was built for — the verifier checks the *oracle's
    interpolation*, not a redefinition of the problem. Trace seeds are
    offset from the builder's (fresh Monte Carlo draws), so prediction
    error includes genuine replicate noise: a small bound certifies both
    the interpolation and the build's seed robustness. Pass ``points``
    (list of ``(mean_rate, burstiness, slo_s)``) to pin the sample, and
    ``device`` for where the compiled backend runs (``None``: the card)."""
    oracle = ScopingOracle(table)
    g = table.grid
    pts = points if points is not None \
        else _sample_points(table, n_samples, seed)
    report = VerificationReport()
    for mr, burst, slo in pts:
        tr = canonical_trace(
            mr, burst, duration_s=g.duration_s, dt_s=g.dt_s,
            n_seeds=g.n_seeds, seed=seed + 104729,
            burst_width_frac=g.burst_width_frac)
        ans = oracle.query(tr, slo)
        if not ans.ok:
            _LOG.warning("oracle verify: refused (%.3g/s, %.2f, %.3gs): %s",
                         mr, burst, slo, ans.reason)
            report.refused += 1
            continue
        scen = TuningScenario(
            name=f"verify({mr:.3g}/s,b{burst:.2f},slo{slo:.3g}s)",
            workload=Workload.from_trace(tr, slo), fleet=fleet,
            policy_cls=policy_cls,
            context=dict(context or {}, slo_s=slo),
            discipline=discipline, max_queue=max_queue, backend=backend,
            device=device)
        ev = evaluate_candidates(scen, [ans.params],
                                 table.objective)[0]
        report.checks.append(SpotCheck(
            mean_rate=mr, burstiness=burst, slo_s=slo,
            params=dict(ans.params),
            predicted_cost=ans.cost_usd_hr,
            predicted_bound=ans.cost_bound_usd_hr,
            simulated_cost=ev.mean_cost(),
            predicted_attainment=ans.attainment,
            simulated_attainment=ev.mean_attainment(),
            exact=ans.exact))
    _LOG.info("%s", report.summary())
    return report
