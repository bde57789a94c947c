"""The fleet's metric catalog, recorded into the instruments of
:mod:`repro_torch._telemetry` (counters, gauges, fixed-bucket histograms and
per-bin series, all labeled: pool, request class, policy family, ...).

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

import numpy as np

from repro_torch._telemetry import MetricsRegistry


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
