"""Nested spans, the tracing half of the telemetry layer: :mod:`repro_torch._telemetry`'s
``Span``, ``SpanTracer`` and ``render_spans`` under their fleet path.

A span is one timed phase of a larger operation — ``tune`` wraps sampling,
each racing round, the SPRT culls, and the surface refine; the compiled
backend wraps every dispatch (tagged cold/warm, which is what splits
compile-seconds from steady-state dispatch-seconds). Spans carry real
durations — they are profiling output, never inputs to any simulation, so
telemetry's bit-exactness guarantee is untouched.
"""
from repro_torch._telemetry import Span, SpanTracer, render_spans  # noqa: F401
