"""Telemetry exporters: JSONL event log, Prometheus text exposition, and an ASCII
sparkline dashboard — :mod:`repro_torch._telemetry`'s, under their fleet path.

All three render the same metrics registry (plus the span tracer and ad-hoc events
for JSONL), so a session exports to whichever sink fits: JSONL for machine-readable
archives, Prometheus text for scrape endpoints, the dashboard for terminals.
"""
from repro_torch._telemetry import (  # noqa: F401
    dashboard,
    metric_events,
    prometheus_text,
    sparkline,
    write_jsonl,
)
