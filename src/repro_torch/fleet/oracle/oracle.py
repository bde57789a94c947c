"""Microsecond-latency scoping: query a precompiled :class:`OracleTable`.

``ScopingOracle`` answers "what shape + controller config should this
workload run on, and what will it cost?" without touching the simulator:
the query featurizes the trace (:mod:`features`), locates the enclosing
grid cell, and multilinearly interpolates the precomputed winners — log-
space along the rate and SLO axes (they span decades), linear along
burstiness. Numeric params interpolate in each dim's own unit coordinates
(``Dim.to_unit``/``from_unit``, so a log-scaled knob interpolates
geometrically); categorical params take the dominant corner. The whole
path is a handful of array ops — microseconds, measured and reported on
every answer.

Queries outside the gridded region are *refused with a reason* rather than
extrapolated: an oracle that guesses beyond its sweep is indistinguishable
from one that knows, and the closed loop needs the distinction to decide
between a config swap (hit) and a warm re-tune (miss).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.fleet.oracle.build import OracleTable
from repro_torch.fleet.oracle.features import TraceFeatures, featurize
from repro_torch.fleet.workload import Workload

_EXACT_RTOL = 1e-9      # relative snap tolerance for the verbatim fast path


@dataclass(frozen=True)
class OracleAnswer:
    """One oracle response. ``ok`` distinguishes an answer from a refusal;
    a refusal carries only ``reason``, ``features`` and ``latency_us``."""
    ok: bool
    reason: str = ""                 # non-empty iff refused
    features: TraceFeatures = None   # the (possibly inflated) query point
    slo_s: float = float("nan")
    params: dict = field(default_factory=dict)
    cost_usd_hr: float = float("nan")        # interpolated winner cost
    cost_bound_usd_hr: float = float("nan")  # max over contributing corners
    attainment: float = float("nan")
    score: float = float("nan")
    cell_idx: tuple = None           # nearest grid cell
    exact: bool = False              # True: verbatim grid-point answer
    corner_idx: tuple = ()           # contributing grid cells (provenance)
    corner_weights: tuple = ()       # their multilinear weights
    latency_us: float = float("nan")

    def __bool__(self) -> bool:
        return self.ok


def _axis_weight(value: float, axis: tuple, log: bool) -> tuple:
    """(lower index, upper-corner weight) for ``value`` on a sorted axis;
    the caller guarantees value is inside [axis[0], axis[-1]]."""
    a = np.asarray(axis, float)
    if len(a) == 1:
        return 0, 0.0
    i = int(np.clip(np.searchsorted(a, value, side="right") - 1,
                    0, len(a) - 2))
    lo, hi = a[i], a[i + 1]
    if log:
        w = float(np.log(value / lo) / np.log(hi / lo))
    else:
        w = float((value - lo) / (hi - lo))
    return i, float(np.clip(w, 0.0, 1.0))


class ScopingOracle:
    """Constant-time scoping answers from an offline-built table.

    >>> oracle = ScopingOracle(OracleTable.load("oracle.json"))
    >>> ans = oracle.query(trace, slo_s=2.0)
    >>> ans.ok, ans.params, ans.cost_usd_hr, ans.latency_us
    """

    def __init__(self, table: OracleTable):
        self.table = table
        g = table.grid
        self._axes = (tuple(g.mean_rates), tuple(g.burstiness),
                      tuple(g.slos))
        self._log = (True, False, True)
        self._axis_names = ("mean_rate", "burstiness", "slo_s")
        self._dims = {d.name: d for d in table.space.dims}

    # ---- query -------------------------------------------------------------

    def query(self, workload, slo_s: float = None, *,
              rate_factor: float = 1.0) -> OracleAnswer:
        """Scope ``workload`` (a Trace, Workload, or TraceFeatures).

        ``slo_s`` is required for a Trace or TraceFeatures; a Workload
        supplies its own (strictest class). ``rate_factor > 1`` inflates the
        query's rate axis — the closed loop's degradation factor: a fleet
        serving f-times slower is scoped as f-times the traffic.
        """
        t0 = time.perf_counter()
        try:
            feats = self._featurize(workload, rate_factor)
            slo = self._resolve_slo(workload, slo_s)
        except (TypeError, ValueError) as e:
            return self._refuse(str(e), None, slo_s, t0)
        point = (feats.mean_rate, feats.burstiness, slo)
        for name, v, axis in zip(self._axis_names, point, self._axes):
            if not (axis[0] - abs(axis[0]) * _EXACT_RTOL <= v
                    <= axis[-1] + abs(axis[-1]) * _EXACT_RTOL):
                return self._refuse(
                    f"{name}={v:g} outside gridded range "
                    f"[{axis[0]:g}, {axis[-1]:g}] — rebuild the table with "
                    f"a wider {name} axis or fall back to tune()",
                    feats, slo, t0)
        iw = [_axis_weight(min(max(v, axis[0]), axis[-1]), axis, lg)
              for v, axis, lg in zip(point, self._axes, self._log)]
        # verbatim fast path: the query sits on a grid point on every axis
        snapped = self._snap(iw)
        if snapped is not None:
            cell = self.table.cells.get(snapped)
            if cell is None:
                return self._refuse(f"grid cell {snapped} was not built",
                                    feats, slo, t0)
            return OracleAnswer(
                ok=True, features=feats, slo_s=slo,
                params=dict(cell.winner), cost_usd_hr=cell.cost_usd_hr,
                cost_bound_usd_hr=cell.cost_usd_hr,
                attainment=cell.attainment, score=cell.score,
                cell_idx=snapped, exact=True,
                corner_idx=(snapped,), corner_weights=(1.0,),
                latency_us=(time.perf_counter() - t0) * 1e6)
        corners, weights = self._corners(iw)
        missing = [c for c in corners if c not in self.table.cells]
        if missing:
            return self._refuse(
                f"grid cell(s) {missing} enclosing the query were not "
                f"built", feats, slo, t0)
        cells = [self.table.cells[c] for c in corners]
        params = self._blend_params(cells, weights)
        active = weights > 1e-12
        cost = float(np.dot(weights, [c.cost_usd_hr for c in cells]))
        bound = float(max(c.cost_usd_hr
                          for c, a in zip(cells, active) if a))
        att = float(np.dot(weights, [c.attainment for c in cells]))
        score = float(np.dot(weights, [c.score for c in cells]))
        nearest = corners[int(np.argmax(weights))]
        return OracleAnswer(
            ok=True, features=feats, slo_s=slo, params=params,
            cost_usd_hr=cost, cost_bound_usd_hr=bound, attainment=att,
            score=score, cell_idx=nearest, exact=False,
            corner_idx=tuple(corners),
            corner_weights=tuple(float(w) for w in weights),
            latency_us=(time.perf_counter() - t0) * 1e6)

    # ---- internals ---------------------------------------------------------

    @staticmethod
    def _featurize(workload, rate_factor: float) -> TraceFeatures:
        if isinstance(workload, TraceFeatures):
            feats = workload
        else:
            feats = featurize(workload)
        return feats if rate_factor == 1.0 else feats.scaled(rate_factor)

    @staticmethod
    def _resolve_slo(workload, slo_s) -> float:
        if slo_s is None:
            if isinstance(workload, Workload):
                slo_s = float(workload.slos().min())
            else:
                raise ValueError(
                    "slo_s is required for a Trace/TraceFeatures query")
        slo = float(slo_s)
        if not np.isfinite(slo) or slo <= 0:
            raise ValueError(f"slo_s must be finite and > 0, got {slo_s}")
        return slo

    def _snap(self, iw: list):
        """Grid index when every axis weight is ~0 or ~1, else None."""
        idx = []
        for (i, w), axis in zip(iw, self._axes):
            if w <= _EXACT_RTOL:
                idx.append(i)
            elif w >= 1.0 - _EXACT_RTOL:
                idx.append(i + 1)
            else:
                return None
        return tuple(idx)

    def _corners(self, iw: list) -> tuple:
        """(corner indices, multilinear weights) — up to 2^3 corners."""
        corners, weights = [], []
        for da in (0, 1):
            for db in (0, 1):
                for dc in (0, 1):
                    w = 1.0
                    idx = []
                    for (i, wt), d, axis in zip(iw, (da, db, dc),
                                                self._axes):
                        if len(axis) == 1:
                            if d == 1:
                                w = 0.0
                            idx.append(i)
                        else:
                            w *= wt if d else (1.0 - wt)
                            idx.append(min(i + d, len(axis) - 1))
                    if w > 0.0:
                        corners.append(tuple(idx))
                        weights.append(w)
        weights = np.asarray(weights, float)
        return corners, weights / weights.sum()

    def _blend_params(self, cells: list, weights: np.ndarray) -> dict:
        """Interpolate winners: numeric dims in their own unit space,
        categorical dims from the dominant corner."""
        dominant = cells[int(np.argmax(weights))]
        params = {}
        for name, dim in self._dims.items():
            vals = [c.winner.get(name) for c in cells]
            if any(v is None for v in vals):
                params[name] = dominant.winner.get(name)
                continue
            if hasattr(dim, "choices"):     # categorical: majority by weight
                tally = {}
                for v, w in zip(vals, weights):
                    tally[v] = tally.get(v, 0.0) + float(w)
                params[name] = max(tally, key=tally.get)
                continue
            u = float(np.dot(weights, [dim.to_unit(v) for v in vals]))
            params[name] = dim.from_unit(u)
        return params

    def _refuse(self, reason: str, feats, slo, t0: float) -> OracleAnswer:
        return OracleAnswer(
            ok=False, reason=reason, features=feats,
            slo_s=float("nan") if slo is None else float(slo),
            latency_us=(time.perf_counter() - t0) * 1e6)


def query_latency_us(oracle: ScopingOracle, workload, slo_s: float = None,
                     *, n: int = 200) -> dict:
    """Measured query latency distribution (microseconds) over ``n``
    repeated queries of the same point — the bench gate's evidence that a
    lookup is constant-time. The first call is excluded (it may fault in
    caches); featurization is included (it is part of every real query)."""
    oracle.query(workload, slo_s)
    lat = np.empty(n)
    for i in range(n):
        lat[i] = oracle.query(workload, slo_s).latency_us
    return {"median_us": float(np.median(lat)),
            "p99_us": float(np.percentile(lat, 99)),
            "max_us": float(lat.max()), "n": int(n)}
