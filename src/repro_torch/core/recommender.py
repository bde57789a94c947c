"""Autonomous container recommendation (the paper's end goal: 'scope out the
cloud containers that would be the most appropriate reference for any prospective
use case').

Given analytic scoping rows (per-shape roofline costs) and a customer constraint,
pick the cheapest feasible CloudShape and produce an elasticity growth plan.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.catalog import CloudShape, get_shape


@dataclass(frozen=True)
class Constraint:
    max_step_latency_s: Optional[float] = None     # real-time surveillance bound
    min_throughput_per_s: Optional[float] = None   # units (tokens/observations)/s
    max_usd_per_hour: Optional[float] = None
    units_per_step: float = 1.0                    # for throughput conversion

    def feasible(self, t_step: float, shape: CloudShape,
                 hbm_used: Optional[float] = None) -> bool:
        if not (t_step > 0.0 and math.isfinite(t_step)):
            return False    # zero/negative/NaN step time = untrustworthy probe
        if self.max_step_latency_s is not None and t_step > self.max_step_latency_s:
            return False
        if (self.min_throughput_per_s is not None
                and self.units_per_step / max(t_step, 1e-12) < self.min_throughput_per_s):
            return False
        if (self.max_usd_per_hour is not None
                and shape.price_per_hour > self.max_usd_per_hour):
            return False
        if hbm_used is not None and hbm_used > shape.hw.hbm_per_chip:
            return False
        return True


@dataclass
class Recommendation:
    shape: Optional[CloudShape]
    t_step: Optional[float]
    usd_per_hour: Optional[float]
    ranking: list                      # [(shape_name, t_step, $/hr, feasible)]
    reason: str = ""


def _rank_key(entry):
    # (price, t_step, chips, name): a total order even when two shapes tie on
    # price AND step time — frozen CloudShape itself is unorderable, so a bare
    # tuple sort would raise TypeError on duplicate-cost rows.
    price, t, shape = entry
    return (price, t, shape.chips, shape.name)


def feasible_ranking(rows, constraint: Constraint) -> list:
    """Feasible ``(price_per_hour, t_step, CloudShape)`` rows, cheapest first.

    This is the ordering ``recommend()`` picks from; heterogeneous fleet
    policies reuse it to split pools into baseline (head of the ranking) and
    burst capacity (the rest)."""
    feasible = []
    for r in rows:
        shape = get_shape(r.shape_name)
        t = r.terms.t_step
        hbm = (r.analysis or {}).get("peak_memory_per_device")
        if constraint.feasible(t, shape, hbm):
            feasible.append((shape.price_per_hour, t, shape))
    feasible.sort(key=_rank_key)
    return feasible


def recommend(rows, constraint: Constraint) -> Recommendation:
    """rows: CellResult list from ContainerStress.run_analytic for ONE use case
    across multiple shapes."""
    ranking = []
    for r in rows:
        shape = get_shape(r.shape_name)
        t = r.terms.t_step
        hbm = (r.analysis or {}).get("peak_memory_per_device")
        ok = constraint.feasible(t, shape, hbm)
        ranking.append((shape.name, t, shape.price_per_hour, ok))
    ranking.sort(key=lambda x: x[2])
    feasible = feasible_ranking(rows, constraint)
    if not feasible:
        return Recommendation(None, None, None, ranking,
                              reason="no catalog shape satisfies the constraint")
    price, t, shape = feasible[0]
    return Recommendation(shape, t, price, ranking,
                          reason=f"cheapest feasible shape ({shape.chips} chips)")


def elasticity_plan(surface, shapes: list, growth_param: str, values: list,
                    base_params: dict, constraint: Constraint) -> list:
    """Growth plan: for each value of the growing parameter (e.g. n_signals as a
    customer instruments more sensors), the cheapest feasible shape predicted by
    the response surface (per-shape surfaces fitted upstream).

    surface: dict shape_name -> ResponseSurface fitted on (params -> t_step).
    Returns [(value, shape_name, predicted_t_step)].
    """
    plan = []
    for v in values:
        params = dict(base_params, **{growth_param: v})
        best = None
        for s in shapes:
            t = surface[s.name].predict(params)
            if constraint.feasible(t, s):
                if best is None or s.price_per_hour < best[2]:
                    best = (s.name, t, s.price_per_hour)
        plan.append((v, best[0] if best else None, best[1] if best else None))
    return plan
