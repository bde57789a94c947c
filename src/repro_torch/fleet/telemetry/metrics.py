"""Structured fleet metrics: counters, gauges, fixed-bucket histograms and
per-bin series, all labeled (pool, request class, policy family, ...).

The registry is the passive half of the telemetry layer: instruments are
plain accumulators with no clocks and no I/O, so recording is deterministic —
two runs of the same seeded simulation populate byte-identical registries,
and the numpy and torch simulator backends emit *identical* streams because
both are recorded from the shared ``simulator._assemble_result`` arrays, not
from backend-internal state.

Naming follows Prometheus conventions (``snake_case``, ``_total`` suffix on
counters, ``_seconds`` units); ``repro_torch.fleet.telemetry.export`` renders the
registry as Prometheus text exposition, JSONL events, or an ASCII sparkline
dashboard.

Metric catalog populated by :func:`record_sim` (one call per simulation):

====================================  =========  ==============================
name                                  kind       labels
====================================  =========  ==============================
``fleet_sim_runs_total``              counter    ``policy``, ``backend-shared``
``fleet_arrived_total``               counter    ``cls``
``fleet_admitted_total``              counter    ``cls``
``fleet_shed_total``                  counter    ``cls``
``fleet_served_total``                counter    ``cls``
``fleet_deadline_miss_total``         counter    ``cls``
``fleet_queue_depth``                 series     ``cls``
``fleet_replicas_ready``              series     ``pool``
``fleet_replicas_pending``            series     ``pool``
``fleet_arrival_rate``                series     —
``fleet_utilization``                 series     —
``fleet_service_time_s``              series     — (per-bin observed mean
                                                 sojourn; the drift probe's
                                                 residual-monitor input)
``fleet_sojourn_seconds``             histogram  ``cls``
``fleet_batch_time_seconds``          histogram  ``pool``
``fleet_preemptions_total``           counter    — (substep core only)
``fleet_residue_bins``                counter    — (bins ending with
                                                 in-flight/checkpointed work)
``fleet_preempted_work``              series     — (batch-seconds preempted
                                                 per bin; substep core only)
====================================  =========  ==============================

Per-seed traces are reduced over the Monte Carlo axis before recording
(counters: mean total per replicate; series: per-bin seed means) so streams
have one value per time bin regardless of the replicate budget.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Latency-shaped default buckets (seconds): sub-10 ms to 5 min, +Inf.
DEFAULT_TIME_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                        10.0, 30.0, 60.0, 120.0, 300.0, float("inf"))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def label_str(labels) -> str:
    """Canonical ``k=v,k2=v2`` rendering (sorted; '' for no labels)."""
    items = labels.items() if isinstance(labels, dict) else labels
    return ",".join(f"{k}={v}" for k, v in sorted(
        (str(k), str(v)) for k, v in items))


@dataclass
class Counter:
    """Monotone accumulator (``_total`` metrics)."""
    name: str
    labels: dict
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)


@dataclass
class Gauge:
    """Last-write-wins point value."""
    name: str
    labels: dict
    value: float = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclass
class Series:
    """A per-bin stream (one float per simulated time bin, appended in
    order). The time-indexed metric the sparkline dashboard plots and the
    drift probe consumes."""
    name: str
    labels: dict
    values: list = field(default_factory=list)

    def extend(self, vals) -> None:
        self.values.extend(float(v) for v in np.asarray(vals, float).ravel())

    def append(self, v: float) -> None:
        self.values.append(float(v))

    def array(self) -> np.ndarray:
        return np.asarray(self.values, float)


@dataclass
class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics):
    ``counts[i]`` is the mass with value <= ``buckets[i]``. ``observe``
    accepts weighted batches (per-request sojourns weighted by cohort
    mass)."""
    name: str
    labels: dict
    buckets: tuple = DEFAULT_TIME_BUCKETS
    counts: np.ndarray = None
    sum: float = 0.0
    count: float = 0.0

    def __post_init__(self):
        self.buckets = tuple(float(b) for b in self.buckets)
        if list(self.buckets) != sorted(self.buckets) or \
                self.buckets[-1] != float("inf"):
            raise ValueError(f"histogram {self.name!r}: buckets must be "
                             "sorted and end with +inf")
        if self.counts is None:
            self.counts = np.zeros(len(self.buckets))

    def observe(self, values, weights=None) -> None:
        v = np.asarray(values, float).ravel()
        w = np.ones_like(v) if weights is None \
            else np.asarray(weights, float).ravel()
        keep = w > 0
        v, w = v[keep], w[keep]
        if v.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.buckets[:-1]), v, side="left")
        np.add.at(self.counts, idx, w)
        self.sum += float((v * w).sum())
        self.count += float(w.sum())

    def cumulative(self) -> np.ndarray:
        return np.cumsum(self.counts)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the covering bucket)."""
        if self.count <= 0:
            return float("nan")
        cum = self.cumulative()
        i = int(np.searchsorted(cum, q * self.count, side="left"))
        return self.buckets[min(i, len(self.buckets) - 1)]


_KINDS = {"counter": Counter, "gauge": Gauge, "series": Series,
          "histogram": Histogram}


class MetricsRegistry:
    """Labeled metric store. ``counter/gauge/series/histogram`` get-or-create
    the instrument for (name, labels); one name maps to one kind."""

    def __init__(self):
        self._metrics: dict = {}     # (name, label_key) -> instrument
        self._kind_of: dict = {}     # name -> kind str

    def _get(self, kind: str, name: str, labels: dict, **kw):
        have = self._kind_of.setdefault(name, kind)
        if have != kind:
            raise ValueError(f"metric {name!r} already registered as {have}, "
                             f"not {kind}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = _KINDS[kind](name=name, labels=dict(labels), **kw)
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def series(self, name: str, **labels) -> Series:
        return self._get("series", name, labels)

    def histogram(self, name: str, buckets=DEFAULT_TIME_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels, buckets=buckets)

    def get(self, name: str, **labels):
        """The instrument for (name, labels), or ``None``."""
        return self._metrics.get((name, _label_key(labels)))

    def __len__(self) -> int:
        return len(self._metrics)

    def items(self):
        """(name, labels, instrument) triples in deterministic order."""
        for key in sorted(self._metrics):
            m = self._metrics[key]
            yield m.name, m.labels, m

    def snapshot(self) -> dict:
        """Plain-python deterministic dump: ``{kind: {name: {label_str:
        value-ish}}}``. Two identically-seeded runs produce equal
        snapshots; the numpy and torch backends produce equal snapshots."""
        out = {"counter": {}, "gauge": {}, "series": {}, "histogram": {}}
        for name, labels, m in self.items():
            kind = self._kind_of[name]
            slot = out[kind].setdefault(name, {})
            ls = label_str(labels)
            if kind == "counter" or kind == "gauge":
                slot[ls] = m.value
            elif kind == "series":
                slot[ls] = list(m.values)
            else:
                slot[ls] = {"buckets": list(m.buckets),
                            "counts": [float(c) for c in m.counts],
                            "sum": m.sum, "count": m.count}
        return out


def service_time_stream(sim) -> np.ndarray:
    """Observed per-bin mean request sojourn (seconds), served-mass-weighted
    across Monte Carlo seeds — the telemetry signal the paper's MSET+SPRT
    prognostic engine monitors for drift. Bins with no served mass carry 0."""
    served = np.asarray(sim.served, float)
    mass = np.asarray(sim.latency_s, float) * served
    tot = served.sum(axis=0)
    return np.divide(mass.sum(axis=0), tot,
                     out=np.zeros_like(tot), where=tot > 0)


def record_sim(registry: MetricsRegistry, sim, slot_bt=None, slot_served=None,
               order=None) -> None:
    """Populate the fleet metric catalog (module docstring) from one
    ``SimResult``. Called by ``simulator._assemble_result`` for every
    simulation run under an active telemetry session — both backends funnel
    through that one assembly path, so their streams are identical. Also
    callable on a bare ``SimResult`` (e.g. the report dashboard);
    ``slot_bt``/``slot_served``/``order`` add the per-pool batch-time
    histogram when the assembly-time slot arrays are at hand."""
    S = sim.arrivals.shape[0]
    registry.counter("fleet_sim_runs_total", policy=sim.policy_name).inc()

    classes = sim.classes or ()
    names = [c.name for c in classes] or ["default"]
    for c, cname in enumerate(names):
        adm = sim.class_admitted[:, :, c] if sim.class_admitted is not None \
            else sim.admitted
        drp = sim.class_dropped[:, :, c] if sim.class_dropped is not None \
            else sim.dropped
        srv = sim.class_served[:, :, c] if sim.class_served is not None \
            else sim.served
        ok = sim.class_ok[:, :, c] if sim.class_ok is not None \
            else sim.ok_served
        qd = sim.class_queue[:, :, c] if sim.class_queue is not None \
            else sim.queue
        registry.counter("fleet_arrived_total", cls=cname).inc(
            float((adm + drp).sum()) / S)
        registry.counter("fleet_admitted_total", cls=cname).inc(
            float(adm.sum()) / S)
        registry.counter("fleet_shed_total", cls=cname).inc(
            float(drp.sum()) / S)
        registry.counter("fleet_served_total", cls=cname).inc(
            float(srv.sum()) / S)
        registry.counter("fleet_deadline_miss_total", cls=cname).inc(
            float((srv - ok).sum()) / S)
        registry.series("fleet_queue_depth", cls=cname).extend(
            qd.mean(axis=0))
        if sim.class_sojourns:
            vals, wts = sim.class_sojourns[c]
            registry.histogram("fleet_sojourn_seconds", cls=cname) \
                .observe(vals, wts)

    for p, pc in enumerate(sim.fleet.pools):
        ready = sim.pool_replicas[:, :, p]
        pending = sim.pool_billed[:, :, p] - ready
        registry.series("fleet_replicas_ready", pool=pc.label).extend(
            ready.mean(axis=0))
        registry.series("fleet_replicas_pending", pool=pc.label).extend(
            pending.mean(axis=0))

    registry.series("fleet_arrival_rate").extend(
        sim.arrivals.mean(axis=0) / sim.dt_s)
    registry.series("fleet_utilization").extend(sim.utilization.mean(axis=0))
    registry.series("fleet_service_time_s").extend(service_time_stream(sim))

    if sim.preemptions is not None:
        # substep-core extras: how often the discipline interrupted a running
        # batch, and how much work was carried across bins as residue
        registry.counter("fleet_preemptions_total").inc(
            float(sim.preemptions.sum()) / S)
        registry.counter("fleet_residue_bins").inc(
            float((sim.residue_work > 0.0).sum()) / S)
        registry.series("fleet_preempted_work").extend(
            sim.preempted_work.mean(axis=0))

    if slot_bt is not None and slot_served is not None and order is not None:
        # slot arrays are drain-rank ordered; label by the pool each rank is
        for rank, p in enumerate(order):
            registry.histogram("fleet_batch_time_seconds",
                               pool=sim.fleet.pools[p].label) \
                .observe(slot_bt[:, :, rank], slot_served[:, :, rank])
