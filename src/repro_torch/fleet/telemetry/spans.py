"""Nested wall-clock spans: the tracing half of the telemetry layer.

A span is one timed phase of a larger operation — ``tune`` wraps sampling,
each racing round, the SPRT culls, and the surface refine; the compiled
backend wraps every jitted dispatch (tagged cold/warm, which is what splits
compile-seconds from steady-state dispatch-seconds). Spans nest: entering a
span inside another parents it, so a completed trace is a tree whose rendered
form is the timing breakdown ``TuningReport.summary()`` prints.

Unlike the metrics registry (deterministic by construction), spans carry real
``time.perf_counter`` durations — they are profiling output, never inputs to
any simulation, so telemetry's bit-exactness guarantee is untouched.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    """One timed phase. ``duration_s`` is None while the span is open."""
    name: str
    attrs: dict = field(default_factory=dict)
    t0: float = 0.0
    duration_s: float = None
    children: list = field(default_factory=list)

    def total(self, name: str) -> float:
        """Summed duration of every descendant (or self) named ``name``."""
        mine = self.duration_s or 0.0 if self.name == name else 0.0
        return mine + sum(c.total(name) for c in self.children)

    def find(self, name: str):
        """First descendant (or self) named ``name``, depth-first."""
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def self_s(self) -> float:
        """Duration not attributed to any child span."""
        return max((self.duration_s or 0.0)
                   - sum(c.duration_s or 0.0 for c in self.children), 0.0)

    def walk(self, depth: int = 0, path: str = ""):
        """(span, depth, /-joined path) triples, depth-first preorder."""
        p = f"{path}/{self.name}" if path else self.name
        yield self, depth, p
        for c in self.children:
            yield from c.walk(depth + 1, p)


def _fmt_attrs(attrs: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(attrs.items(),
                                                  key=lambda kv: str(kv[0])))


def render_spans(roots, unit_s: float = None) -> str:
    """ASCII tree of one or more span trees with durations and attrs::

        tune                        4.213s
          sample                    0.002s  n=24 sampler=lhs
          race                      3.950s
            round                   1.201s  alive=24 s0=0 s1=2
    """
    lines = []
    width = max((len("  " * d + s.name) for r in roots
                 for s, d, _ in r.walk()), default=0) + 2
    for root in roots:
        for s, d, _ in root.walk():
            label = "  " * d + s.name
            dur = "   open " if s.duration_s is None \
                else f"{s.duration_s:7.3f}s"
            attrs = _fmt_attrs(s.attrs)
            lines.append(f"{label:<{width}}{dur}" + (f"  {attrs}" if attrs
                                                     else ""))
    return "\n".join(lines)


class SpanTracer:
    """Collects span trees for one telemetry session."""

    def __init__(self, clock=time.perf_counter):
        self.roots: list = []
        self._stack: list = []
        self._clock = clock

    @contextmanager
    def span(self, name: str, **attrs):
        s = Span(name=name, attrs=attrs, t0=self._clock())
        (self._stack[-1].children if self._stack else self.roots).append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.duration_s = self._clock() - s.t0
            self._stack.pop()

    def current(self):
        return self._stack[-1] if self._stack else None

    def find(self, name: str):
        """Last root-level tree containing ``name`` wins (a session may run
        several tunes; callers want the one just finished)."""
        for root in reversed(self.roots):
            hit = root.find(name)
            if hit is not None:
                return hit
        return None

    def total(self, name: str) -> float:
        return sum(r.total(name) for r in self.roots)

    def render(self) -> str:
        return render_spans(self.roots)

    def to_events(self) -> list:
        """Flattened span records for the JSONL exporter."""
        out = []
        for root in self.roots:
            for s, depth, path in root.walk():
                out.append({"type": "span", "name": s.name, "path": path,
                            "depth": depth, "duration_s": s.duration_s,
                            **{f"attr_{k}": v for k, v in s.attrs.items()}})
        return out
