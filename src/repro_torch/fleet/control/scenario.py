"""Closed-loop experiment cases: a live workload plus a scheduled mid-trace
world change the controller must detect and recover from.

The simulation *is* the world here: the controller only sees telemetry, so a
drift case injects its degradation by swapping a service-degraded fleet into
the running :class:`~repro_torch.fleet.simulator.SegmentedSimulation` at a scheduled
bin (``SegmentedSimulation.swap(fleet=...)``) — exactly the silently-decaying
node the paper's prognostic engine watches for, landing mid-trace under the
incumbent policy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.fleet.simulator import FleetConfig
from repro_torch.fleet.telemetry.drift import degrade_fleet
from repro_torch.fleet.workload import Trace, Workload


def tail_workload(wl: Workload, t0: int) -> Workload:
    """The workload's remaining bins ``[t0, T)`` — what a drift response
    re-tunes against (the past is sunk; only the rest of the trace is
    actionable)."""
    if not 0 <= t0 < wl.n_bins:
        raise ValueError(f"bad tail start {t0} for {wl.n_bins} bins")
    traces = tuple(Trace(tr.name, tr.dt_s, tr.rate[t0:],
                         tr.arrivals[:, t0:]) for tr in wl.traces)
    return Workload(wl.name, wl.classes, traces)


@dataclass(frozen=True)
class DriftCase:
    """One closed-loop experiment: the live trace, the nominal fleet the
    incumbent was scoped for, and the scheduled world-side fleet swaps
    (``{t_bin: degraded FleetConfig}``) the controller must survive."""
    workload: Workload
    fleet: FleetConfig               # nominal (pre-drift) fleet
    inject: dict = field(default_factory=dict)
    description: str = ""

    @property
    def n_bins(self) -> int:
        return self.workload.n_bins

    def drift_bins(self) -> list:
        return sorted(self.inject)


def service_degradation_case(workload, fleet: FleetConfig, *,
                             factor: float = 1.5,
                             t_drift: int = None,
                             t_drift_frac: float = 0.5,
                             slo_s: float = None) -> DriftCase:
    """The canonical injected-drift case: at ``t_drift`` (default: halfway
    through the trace) every pool's service times inflate by ``factor`` —
    same hardware, same prices, silently slower — and stay degraded to the
    end. ``factor <= 1`` is rejected: that is not a degradation."""
    if isinstance(workload, Trace):
        if slo_s is None:
            raise ValueError("a bare Trace needs slo_s for its request class")
        workload = Workload.from_trace(workload, float(slo_s))
    if factor <= 1.0:
        raise ValueError(f"degradation factor must be > 1, got {factor}")
    T = workload.n_bins
    t = int(round(T * t_drift_frac)) if t_drift is None else int(t_drift)
    if not 0 < t < T:
        raise ValueError(f"drift bin {t} must lie strictly inside (0, {T})")
    return DriftCase(
        workload=workload, fleet=fleet,
        inject={t: degrade_fleet(fleet, factor)},
        description=f"service x{factor:g} degradation at bin {t}/{T}")
