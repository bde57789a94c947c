"""Fleet SLO/cost reporting: percentile latency, attainment, utilization, and
dollar cost (via the core cost model) per policy, plus comparison tables.

Attainment and percentiles are exact: ``simulate`` carries per-request cohort
accounting (``ok_served``, the pooled sojourn distribution), so ``summarize``
reads them off instead of re-deriving them from per-bin mean latencies."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.cost_model import dollar_cost
from repro_torch.core.report import fmt_time, markdown_table
from repro_torch.fleet.simulator import SimResult


def weighted_percentile(values: np.ndarray, weights: np.ndarray,
                        q: float) -> float:
    """Percentile q in [0, 100] of ``values`` where each value counts
    ``weights`` times (per-request sojourns weighted by cohort mass).
    q=0 returns the min, q=100 the max; all-zero weights give NaN."""
    v = np.asarray(values, float).ravel()
    w = np.asarray(weights, float).ravel()
    keep = w > 0
    v, w = v[keep], w[keep]
    if len(v) == 0:
        return float("nan")
    order = np.argsort(v)
    v, w = v[order], w[order]
    cdf = np.cumsum(w) / w.sum()
    return float(v[np.searchsorted(cdf, q / 100.0, side="left").clip(0, len(v) - 1)])


@dataclass(frozen=True)
class ClassReport:
    """Per-request-class slice of a ``FleetReport`` (attainment is per the
    class's own SLO; cost is the whole fleet's — capacity is shared)."""
    name: str
    slo_s: float
    share: float                # fraction of total arrivals
    p50_s: float
    p95_s: float
    p99_s: float
    attainment: float
    drop_rate: float


@dataclass(frozen=True)
class FleetReport:
    policy: str
    trace: str
    shape: str                  # "+"-joined pool shapes for mixed fleets
    slo_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    slo_attainment: float       # served in-SLO / completed (drops violate;
    #                             end-of-trace backlog is excluded — those
    #                             requests never got an outcome either way)
    mean_utilization: float
    drop_rate: float
    mean_replicas: float        # billed (ready + cold-starting) — the same
    #                             quantity the cost columns integrate
    usd_total: float            # mean over MC seeds, whole trace
    usd_per_hour: float
    discipline: str = "fifo"
    class_reports: tuple = ()   # ClassReport per request class

    def worst_class_attainment(self) -> float:
        """The binding SLO: the lowest per-class attainment (multi-class
        fleets must meet *every* class's bar, not the traffic-weighted mix)."""
        if not self.class_reports:
            return self.slo_attainment
        return min(c.attainment for c in self.class_reports)

    def row(self) -> list:
        return [self.policy, self.trace, self.shape,
                fmt_time(self.p50_s), fmt_time(self.p95_s),
                fmt_time(self.p99_s),
                f"{self.slo_attainment * 100:.1f}%",
                f"{self.mean_utilization * 100:.0f}%",
                f"{self.drop_rate * 100:.2f}%",
                f"{self.mean_replicas:.1f}",
                f"${self.usd_per_hour:.2f}/hr"]


REPORT_HEADERS = ["policy", "trace", "shape", "p50", "p95", "p99", "SLO",
                  "util", "drop", "replicas", "cost"]


def _class_reports(sim: SimResult, total_arrived: float) -> tuple:
    if sim.workload is None or sim.class_served is None:
        return ()
    out = []
    for c, rc in enumerate(sim.classes):
        arrived = float(sim.class_admitted[:, :, c].sum()
                        + sim.class_dropped[:, :, c].sum())
        completed = arrived - float(sim.class_queue[:, -1, c].sum())
        vals, weights = sim.class_sojourns[c]
        out.append(ClassReport(
            name=rc.name, slo_s=rc.slo_s,
            share=arrived / max(total_arrived, 1.0),
            p50_s=weighted_percentile(vals, weights, 50),
            p95_s=weighted_percentile(vals, weights, 95),
            p99_s=weighted_percentile(vals, weights, 99),
            attainment=(float(sim.class_ok[:, :, c].sum() / completed)
                        if completed > 0 else 1.0),
            drop_rate=float(sim.class_dropped[:, :, c].sum()
                            / max(arrived, 1.0))))
    return tuple(out)


def summarize(sim: SimResult) -> FleetReport:
    total_arrived = sim.arrivals.sum()
    # completed = everything that left the system (served or dropped); the
    # terminal in-queue backlog never resolved, so it belongs to neither the
    # numerator nor the denominator of attainment
    completed = total_arrived - sim.queue[:, -1].sum()
    attainment = (float(sim.ok_served.sum() / completed) if completed > 0
                  else 1.0)      # no traffic = vacuously met
    usd = sim.billed_usd()
    hours = sim.trace.duration_s / 3600.0
    util = sim.utilization[sim.replicas > 0]
    return FleetReport(
        policy=sim.policy_name,
        trace=sim.trace.name,
        shape=sim.fleet.shape_label(),
        slo_s=sim.slo_s,
        p50_s=weighted_percentile(sim.sojourn_values, sim.sojourn_weights, 50),
        p95_s=weighted_percentile(sim.sojourn_values, sim.sojourn_weights, 95),
        p99_s=weighted_percentile(sim.sojourn_values, sim.sojourn_weights, 99),
        slo_attainment=attainment,
        mean_utilization=float(util.mean()) if util.size else 0.0,
        drop_rate=float(sim.dropped.sum() / max(total_arrived, 1.0)),
        mean_replicas=float(sim.billed_replicas.mean()),
        usd_total=usd,
        usd_per_hour=usd / max(hours, 1e-12),
        discipline=sim.discipline,
        class_reports=_class_reports(sim, float(total_arrived)),
    )


@dataclass(frozen=True)
class WindowMetrics:
    """SLO/cost scalars over one bin window of a simulation — what the
    closed-loop controller and its benchmark read per control segment.
    Attainment is window-local: served/dropped mass *within* the window
    against the ok mass within it (requests still queued at ``t1`` belong
    to a later window)."""
    t0: int
    t1: int
    slo_attainment: float            # pooled over classes
    worst_class_attainment: float
    usd: float                       # mean over MC seeds, window total
    usd_per_hour: float
    mean_utilization: float
    mean_queue: float
    mean_replicas: float             # billed


def window_metrics(sim: SimResult, t0: int, t1: int = None) -> WindowMetrics:
    """Per-window analogue of ``summarize``: attainment, utilization and
    dollar cost over bins ``[t0, t1)`` (``t1=None``: to the end). The
    closed-loop recovery gate compares pre-drift, post-drift, and
    post-recovery windows of one continuous trace with this."""
    T = sim.arrivals.shape[1]
    t1 = T if t1 is None else int(t1)
    t0 = int(t0)
    if not 0 <= t0 < t1 <= T:
        raise ValueError(f"bad window [{t0}, {t1}) for {T} bins")
    completed = float((sim.served + sim.dropped)[:, t0:t1].sum())
    pooled = (float(sim.ok_served[:, t0:t1].sum() / completed)
              if completed > 0 else 1.0)
    worst = pooled
    if sim.class_ok is not None:
        done_c = (sim.class_served + sim.class_dropped)[:, t0:t1, :].sum(
            axis=(0, 1))
        ok_c = sim.class_ok[:, t0:t1, :].sum(axis=(0, 1))
        att_c = np.divide(ok_c, done_c, out=np.ones_like(ok_c),
                          where=done_c > 0)
        worst = float(att_c.min())
    usd = 0.0
    for p, pc in enumerate(sim.fleet.pools):
        bins = float(sim.pool_billed[:, t0:t1, p].sum(axis=1).mean())
        usd += dollar_cost(sim.dt_s, bins, pc.service.shape.chips,
                           pc.service.shape.hw)
    hours = (t1 - t0) * sim.dt_s / 3600.0
    util = sim.utilization[:, t0:t1][sim.replicas[:, t0:t1] > 0]
    return WindowMetrics(
        t0=t0, t1=t1, slo_attainment=pooled, worst_class_attainment=worst,
        usd=usd, usd_per_hour=usd / max(hours, 1e-12),
        mean_utilization=float(util.mean()) if util.size else 0.0,
        mean_queue=float(sim.queue[:, t0:t1].mean()),
        mean_replicas=float(sim.billed_replicas[:, t0:t1].mean()))


def comparison_table(reports: list) -> str:
    """Markdown policy-comparison table, grouped by trace then cost."""
    rows = [r.row() for r in sorted(reports, key=lambda r: (r.trace, r.usd_per_hour))]
    return markdown_table(REPORT_HEADERS, rows)


def telemetry_dashboard(sim: SimResult, width: int = 60) -> str:
    """ASCII sparkline dashboard of one simulation's telemetry streams
    (queue depth, replicas, arrival rate, utilization, observed service
    times), rendered from a throwaway registry — works on any finished
    ``SimResult``, no active telemetry session required."""
    from repro_torch.fleet.telemetry import MetricsRegistry, record_sim
    from repro_torch.fleet.telemetry.export import dashboard

    reg = MetricsRegistry()
    record_sim(reg, sim)
    return dashboard(reg, width=width)


def best_per_trace(reports: list, min_attainment: float = 0.99) -> list:
    """Cheapest report per trace among those meeting ``min_attainment``."""
    best = {}
    for r in reports:
        if r.slo_attainment < min_attainment:
            continue
        if r.trace not in best or r.usd_per_hour < best[r.trace].usd_per_hour:
            best[r.trace] = r
    return [best[k] for k in sorted(best)]


def cost_efficiency_table(reports: list, min_attainment: float = 0.99) -> str:
    """Homogeneous-vs-mixed scoreboard: per trace, every (shape, policy) fleet
    meeting the attainment bar, cheapest first, with its premium over the
    winner."""
    by_trace = {}
    for r in reports:
        by_trace.setdefault(r.trace, []).append(r)
    rows = []
    for trace in sorted(by_trace):
        ok = sorted((r for r in by_trace[trace]
                     if r.slo_attainment >= min_attainment),
                    key=lambda r: r.usd_per_hour)
        for r in ok:
            premium = r.usd_per_hour / ok[0].usd_per_hour - 1.0
            rows.append([trace, r.shape, r.policy,
                         f"{r.slo_attainment * 100:.1f}%",
                         f"${r.usd_per_hour:.2f}/hr",
                         "winner" if r is ok[0] else f"+{premium * 100:.0f}%"])
        if not ok:
            rows.append([trace, "-", "-", f"<{min_attainment * 100:.0f}%",
                         "-", "no fleet met the SLO bar"])
    return markdown_table(
        ["trace", "shape", "policy", "SLO", "cost", "vs winner"], rows)


CLASS_HEADERS = ["policy", "discipline", "trace", "class", "SLO", "share",
                 "p50", "p95", "p99", "attainment", "drop", "cost"]


def class_table(reports: list) -> str:
    """Per-class attainment/cost table: one row per (fleet run, request
    class), grouped by trace then discipline. The cost column is the whole
    fleet's $/hr — capacity is shared, so a class's bill is the fleet's."""
    rows = []
    for r in sorted(reports, key=lambda r: (r.trace, r.discipline, r.policy)):
        for c in (r.class_reports
                  or (ClassReport("all", r.slo_s, 1.0, r.p50_s, r.p95_s,
                                  r.p99_s, r.slo_attainment, r.drop_rate),)):
            rows.append([r.policy, r.discipline, r.trace, c.name,
                         fmt_time(c.slo_s), f"{c.share * 100:.0f}%",
                         fmt_time(c.p50_s), fmt_time(c.p95_s),
                         fmt_time(c.p99_s),
                         f"{c.attainment * 100:.2f}%",
                         f"{c.drop_rate * 100:.2f}%",
                         f"${r.usd_per_hour:.2f}/hr"])
    return markdown_table(CLASS_HEADERS, rows)
