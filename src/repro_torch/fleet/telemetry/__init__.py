"""Opt-in fleet telemetry: structured metrics, span tracing, a drift-probe
substrate, and exporters (JSONL / Prometheus text / ASCII dashboard). The
sessions, spans, instruments and exporters are :mod:`repro_torch._telemetry`'s,
re-exported here, so one session sees the fleet's telemetry and that of MSET2
and the kernels alike.

The paper's autonomous loop is built on *observing* the running container —
its MSET+SPRT prognostic engine consumes telemetry streams to detect
deviation from the predicted envelope. This package is that observation
layer for the fleet pipeline: the simulator records per-bin metric streams,
the tuner and the compiled backend record timing spans, and
:mod:`repro_torch.fleet.telemetry.drift` feeds the observed service-time stream
back into ``repro_torch.mset`` as a residual monitor.

Usage — telemetry is **off by default**; instrumented code paths are exact
no-ops (bit-identical results, negligible overhead) until a session is
opened::

    from repro_torch.fleet import telemetry

    with telemetry.session() as tel:
        sim = simulate_fleet(workload, fleet, policy)
        report = tune(scenario)
    print(tel.dashboard())          # ASCII sparklines
    print(tel.tracer.render())      # span tree
    tel.export_jsonl("events.jsonl")

Instrumented code calls the module-level helpers (:func:`span`,
:func:`counter`, :func:`event`, :func:`record`), which dispatch to the
innermost active session or do nothing. Sessions nest (a scoped probe inside
a long-lived session records to the inner one alone); the stack is
thread-local in spirit but process-global in fact, matching the repo's
single-threaded simulators.
"""
from __future__ import annotations

from repro_torch._telemetry import (
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
    Span,
    SpanTracer,
    Telemetry,
    active,
    counter,
    event,
    gauge,
    label_str,
    render_spans,
    session,
    span,
)
from repro_torch.fleet.telemetry import export
from repro_torch.fleet.telemetry.metrics import record_sim, service_time_stream

__all__ = [
    "Telemetry", "session", "active", "span", "counter", "gauge", "event",
    "record",
    "MetricsRegistry", "Counter", "Gauge", "Series", "Histogram",
    "DEFAULT_TIME_BUCKETS", "label_str", "record_sim", "service_time_stream",
    "Span", "SpanTracer", "render_spans", "export",
    # lazy (see __getattr__): DriftProbe, DriftReport, telemetry_matrix,
    "drift",
]


def record(sim, slot_bt=None, slot_served=None, order=None) -> None:
    """Record a ``SimResult``'s metric streams into the active session;
    no-op when disabled. The simulator calls this from its shared
    ``_assemble_result`` path so both backends emit identical streams."""
    tel = active()
    if tel is not None:
        record_sim(tel.metrics, sim, slot_bt=slot_bt,
                   slot_served=slot_served, order=order)


_LAZY = ("DriftProbe", "DriftReport", "DEFAULT_SIGNALS", "telemetry_matrix",
         "degrade_fleet", "drift")


def __getattr__(name: str):
    # drift pulls in repro_torch.mset and the kernels' wrappers; keep the
    # session machinery importable without touching them.
    if name in _LAZY:
        import importlib
        mod = importlib.import_module("repro_torch.fleet.telemetry.drift")
        if name == "drift":
            return mod
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
