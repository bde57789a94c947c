"""Opt-in fleet telemetry: structured metrics, wall-clock span tracing, a
drift-probe substrate, and exporters (JSONL / Prometheus text / ASCII
dashboard).

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

from contextlib import contextmanager
from dataclasses import dataclass, field

from repro_torch.fleet.telemetry import export
from repro_torch.fleet.telemetry.metrics import (
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
    label_str,
    record_sim,
    service_time_stream,
)
from repro_torch.fleet.telemetry.spans import Span, SpanTracer, render_spans

__all__ = [
    "Telemetry", "session", "active", "span", "counter", "gauge", "event",
    "record",
    "MetricsRegistry", "Counter", "Gauge", "Series", "Histogram",
    "DEFAULT_TIME_BUCKETS", "label_str", "record_sim", "service_time_stream",
    "Span", "SpanTracer", "render_spans", "export",
    # lazy (see __getattr__): DriftProbe, DriftReport, telemetry_matrix,
    "drift",
]


@dataclass
class Telemetry:
    """One telemetry session: a metrics registry + a span tracer + an ad-hoc
    event list, with exporter conveniences."""
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: SpanTracer = field(default_factory=SpanTracer)
    events: list = field(default_factory=list)

    def event(self, name: str, **fields) -> dict:
        ev = {"name": name, **fields}
        self.events.append(ev)
        return ev

    def export_jsonl(self, path) -> int:
        """Write events + metrics + spans as a JSONL log; returns #lines."""
        return export.write_jsonl(path, registry=self.metrics,
                                  tracer=self.tracer, events=self.events)

    def prometheus(self) -> str:
        return export.prometheus_text(self.metrics)

    def dashboard(self, width: int = 60) -> str:
        return export.dashboard(self.metrics, width=width)


_STACK: list = []


def active() -> Telemetry:
    """The innermost active session, or ``None`` (telemetry disabled)."""
    return _STACK[-1] if _STACK else None


@contextmanager
def session(tel: Telemetry = None):
    """Enable telemetry for the dynamic extent of the block. Yields the
    :class:`Telemetry` session (a fresh one unless ``tel`` is passed)."""
    tel = tel if tel is not None else Telemetry()
    _STACK.append(tel)
    try:
        yield tel
    finally:
        _STACK.pop()


@contextmanager
def span(name: str, **attrs):
    """Time a phase in the active session's tracer; no-op when disabled.
    Yields the open :class:`Span` (or ``None``)."""
    tel = active()
    if tel is None:
        yield None
        return
    with tel.tracer.span(name, **attrs) as s:
        yield s


def counter(name: str, value: float = 1.0, **labels) -> None:
    """Increment a counter in the active session; no-op when disabled."""
    tel = active()
    if tel is not None:
        tel.metrics.counter(name, **labels).inc(value)


def gauge(name: str, value: float, **labels) -> None:
    """Set a gauge in the active session; no-op when disabled."""
    tel = active()
    if tel is not None:
        tel.metrics.gauge(name, **labels).set(value)


def event(name: str, **fields) -> None:
    """Append an ad-hoc event in the active session; no-op when disabled."""
    tel = active()
    if tel is not None:
        tel.event(name, **fields)


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
    # drift pulls in torch, repro_torch.mset and the kernels' wrappers; keep
    # the core session machinery importable without touching them.
    if name in _LAZY:
        import importlib
        mod = importlib.import_module("repro_torch.fleet.telemetry.drift")
        if name == "drift":
            return mod
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
