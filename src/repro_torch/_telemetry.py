"""The port's telemetry: metrics, spans and sessions, one system for every layer.

Telemetry is **off by default**: instrumented code calls the module-level helpers
(:func:`span`, :func:`counter`, :func:`gauge`, :func:`event`, :func:`device_counter`),
which record into the innermost open session and otherwise do nothing, so results are
bit-identical with it on or off::

    from repro_torch import _telemetry as telemetry

    with telemetry.session() as tel:
        model = mset2.train(X, 8192)
    print(tel.tracer.render())      # span tree, host and device times
    tel.export_jsonl("events.jsonl")

A span has two sinks. While ``torch.profiler`` records, it is a ``record_function``
range under exactly its name, so it sits on the device trace's clock and every kernel
launched inside it is attributed to it. While a session is open, it is a node of the
session's span tree whose start is on the same clock (Unix ns, as the profiler's
``start_ns`` reads), with a pair of CUDA events on the current stream when CUDA is in
use; the events' time is read only by the exporters, never on the hot path, since a
host-clock span around asynchronous work times the launch and not the work. With
neither on, a span is one check and a shared no-op context.

Sessions nest (a scoped probe inside a long-lived session records to the inner one
alone); the stack is process-global, matching the repo's single-threaded callers.
``repro_torch.fleet.telemetry`` re-exports this module's objects beside the fleet's
own metric catalog, so one session sees fleet, MSET2 and kernel telemetry alike. The
module imports nothing of the port, so every layer can import it.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import _profiler_enabled

# ---------------------------------------------------------------- instruments


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


# ---------------------------------------------------------------- spans


def _cuda_event():
    """A timing event recorded on the current stream, or None where none can be: CUDA
    unused in this process, or the stream capturing a graph."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@dataclass
class Span:
    """One timed phase. ``duration_s`` is None while the span is open; ``start_ns`` is
    on the profiler's clock (Unix ns); ``events`` are its CUDA start and end events,
    None where CUDA is unused."""
    name: str
    attrs: dict = field(default_factory=dict)
    t0: float = 0.0
    duration_s: float = None
    children: list = field(default_factory=list)
    start_ns: int = 0
    events: tuple = field(default=None, repr=False, compare=False)

    @property
    def device_ms(self):
        """Milliseconds on the card between the span's two events, or None. Waits for
        the end event: exporters read it, the hot path never does."""
        if self.events is None or self.events[1] is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)

    def find(self, name: str):
        """First descendant (or self) named ``name``, depth-first."""
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

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
    """ASCII tree of one or more span trees with host durations, device times where
    the span's work ran on the card, and attrs::

        mset2.train                     0.525s  dev   545.135ms
          mset2.train.standardize       0.001s  dev     0.570ms
          mset2.train.pinv              0.521s  dev   540.240ms
    """
    lines = []
    width = max((len("  " * d + s.name) for r in roots
                 for s, d, _ in r.walk()), default=0) + 2
    for root in roots:
        for s, d, _ in root.walk():
            label = "  " * d + s.name
            dur = "   open " if s.duration_s is None \
                else f"{s.duration_s:7.3f}s"
            dev = s.device_ms
            if dev is not None:
                dur += f"  dev {dev:9.3f}ms"
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

    def open(self, name: str, attrs: dict) -> Span:
        s = Span(name=name, attrs=attrs, t0=self._clock(), start_ns=time.time_ns())
        (self._stack[-1].children if self._stack else self.roots).append(s)
        self._stack.append(s)
        start = _cuda_event()
        if start is not None:
            s.events = (start, None)
        return s

    def close(self, s: Span) -> None:
        if s.events is not None:
            end = _cuda_event()
            s.events = None if end is None else (s.events[0], end)
        s.duration_s = self._clock() - s.t0
        self._stack.pop()

    @contextmanager
    def span(self, name: str, **attrs):
        s = self.open(name, attrs)
        try:
            yield s
        finally:
            self.close(s)

    def find(self, name: str):
        """Last root-level tree containing ``name`` wins (a session may run
        several tunes; callers want the one just finished)."""
        for root in reversed(self.roots):
            hit = root.find(name)
            if hit is not None:
                return hit
        return None

    def render(self) -> str:
        return render_spans(self.roots)

    def to_events(self) -> list:
        """Flattened span records for the JSONL exporter."""
        out = []
        for root in self.roots:
            for s, depth, path in root.walk():
                out.append({"type": "span", "name": s.name, "path": path,
                            "depth": depth, "duration_s": s.duration_s,
                            "start_ns": s.start_ns, "device_ms": s.device_ms,
                            **{f"attr_{k}": v for k, v in s.attrs.items()}})
        return out


# ---------------------------------------------------------------- exporters

# 8-level unicode sparkline ramp (" " for empty bins keeps rows aligned)
_SPARK = "▁▂▃▄▅▆▇█"


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    items = sorted((str(k), str(v)) for k, v in labels.items())
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def _prom_num(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format (version 0.0.4). Counters and gauges
    export as-is; a series exports its last value as a gauge (the "current"
    sample a scraper would see) plus a ``_bins`` gauge with its length;
    histograms export cumulative ``_bucket{le=...}`` rows, ``_sum`` and
    ``_count``."""
    by_name: dict = {}
    kinds: dict = {}
    for name, labels, m in registry.items():
        kind = type(m).__name__.lower()
        kinds[name] = kind
        by_name.setdefault(name, []).append((labels, m))
    lines = []
    for name in sorted(by_name):
        kind = kinds[name]
        if kind == "series":
            lines.append(f"# TYPE {name} gauge")
            for labels, m in by_name[name]:
                last = m.values[-1] if m.values else float("nan")
                lines.append(f"{name}{_prom_labels(labels)} "
                             f"{_prom_num(last)}")
                lines.append(f"{name}_bins{_prom_labels(labels)} "
                             f"{len(m.values)}")
            continue
        if kind == "histogram":
            lines.append(f"# TYPE {name} histogram")
            for labels, m in by_name[name]:
                cum = m.cumulative()
                for le, c in zip(m.buckets, cum):
                    lab = dict(labels)
                    lab["le"] = _prom_num(le)
                    lines.append(f"{name}_bucket{_prom_labels(lab)} "
                                 f"{_prom_num(float(c))}")
                lines.append(f"{name}_sum{_prom_labels(labels)} "
                             f"{_prom_num(m.sum)}")
                lines.append(f"{name}_count{_prom_labels(labels)} "
                             f"{_prom_num(m.count)}")
            continue
        lines.append(f"# TYPE {name} {kind}")
        for labels, m in by_name[name]:
            lines.append(f"{name}{_prom_labels(labels)} {_prom_num(m.value)}")
    return "\n".join(lines) + "\n"


def metric_events(registry: MetricsRegistry) -> list:
    """One JSON-able record per instrument (the JSONL metric dump)."""
    out = []
    for name, labels, m in registry.items():
        kind = type(m).__name__.lower()
        rec = {"type": kind, "name": name, "labels": dict(labels)}
        if kind in ("counter", "gauge"):
            rec["value"] = m.value
        elif kind == "series":
            rec["values"] = list(m.values)
        else:
            rec.update(buckets=list(m.buckets),
                       counts=[float(c) for c in m.counts],
                       sum=m.sum, count=m.count)
        out.append(rec)
    return out


def write_jsonl(path, registry: MetricsRegistry = None, tracer=None,
                events=None) -> int:
    """Write the session's telemetry as a JSONL event log — one JSON object
    per line: ad-hoc events first (in emission order), then metrics, then
    spans. Returns the number of lines written."""
    records = []
    for ev in (events or []):
        records.append({"type": "event", **ev})
    if registry is not None:
        records.extend(metric_events(registry))
    if tracer is not None:
        records.extend(tracer.to_events())
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True,
                               default=_json_default) + "\n")
    return len(records)


def _json_default(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if v == float("inf"):
        return "+Inf"
    return str(v)


def sparkline(values, width: int = 60) -> str:
    """Compress a series into ``width`` sparkline chars (block ramp, scaled
    to the series' own min..max; a flat series renders mid-ramp)."""
    v = np.asarray(values, float).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        return ""
    if v.size > width:
        # mean-pool into `width` windows so bursts stay visible
        edges = np.linspace(0, v.size, width + 1).astype(int)
        v = np.array([v[a:b].mean() if b > a else v[min(a, v.size - 1)]
                      for a, b in zip(edges[:-1], edges[1:])])
    lo, hi = float(v.min()), float(v.max())
    if hi - lo <= 1e-12:
        return _SPARK[3] * len(v)
    idx = ((v - lo) / (hi - lo) * (len(_SPARK) - 1)).round().astype(int)
    return "".join(_SPARK[i] for i in idx)


def dashboard(registry: MetricsRegistry, width: int = 60) -> str:
    """ASCII sparkline dashboard over every series in the registry, plus a
    compact totals line per counter family and bucket-quantile summaries per
    histogram — the terminal rendering ``repro_torch.fleet.report`` wires into
    fleet reports."""
    series, counters, hists = [], {}, []
    for name, labels, m in registry.items():
        kind = type(m).__name__.lower()
        if kind == "series":
            series.append((name, labels, m))
        elif kind == "counter":
            counters.setdefault(name, []).append((labels, m))
        elif kind == "histogram":
            hists.append((name, labels, m))
    lines = []
    if series:
        label_w = max(len(_series_label(n, lb)) for n, lb, _ in series) + 2
        for name, labels, m in series:
            v = m.array()
            stats = (f"min {v.min():.3g}  mean {v.mean():.3g}  "
                     f"max {v.max():.3g}" if v.size else "empty")
            lines.append(f"{_series_label(name, labels):<{label_w}}"
                         f"{sparkline(v, width):<{width}}  {stats}")
    if hists:
        lines.append("")
        for name, labels, m in hists:
            lines.append(f"{_series_label(name, labels)}: "
                         f"count {m.count:.0f}  mean "
                         f"{(m.sum / m.count if m.count else float('nan')):.3g}"
                         f"  p50<={m.quantile(0.5):g}  p99<={m.quantile(0.99):g}")
    if counters:
        lines.append("")
        for name in sorted(counters):
            parts = ", ".join(
                f"{label_str(labels) or 'total'}={m.value:g}"
                for labels, m in counters[name])
            lines.append(f"{name}: {parts}")
    return "\n".join(lines)


def _series_label(name: str, labels: dict) -> str:
    ls = label_str(labels)
    return f"{name}{{{ls}}}" if ls else name


# ---------------------------------------------------------------- sessions


@dataclass
class Telemetry:
    """One telemetry session: a metrics registry + a span tracer + an ad-hoc
    event list + counters kept on the device, with exporter conveniences."""
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: SpanTracer = field(default_factory=SpanTracer)
    events: list = field(default_factory=list)
    device_counters: dict = field(default_factory=dict)

    def event(self, name: str, **fields) -> dict:
        ev = {"name": name, **fields}
        self.events.append(ev)
        return ev

    def device_counter(self, name: str, device, size: int = 1, **labels) -> torch.Tensor:
        """The session's zeroed int64 tensor of ``size`` on ``device`` for counter
        ``name``: device code adds to it, and its element 0 is the counter's value
        once :meth:`settle` has read it."""
        device = torch.device(device)
        key = (name, _label_key(labels), str(device))
        t = self.device_counters.get(key)
        if t is None:
            t = torch.zeros(size, dtype=torch.int64, device=device)
            self.device_counters[key] = t
            self.metrics.counter(name, **labels)
        return t

    def settle(self) -> None:
        """Read the counters kept on the device into the registry (waits for the
        device); the exporters call it."""
        totals: dict = {}
        for (name, labels, _), t in self.device_counters.items():
            totals[(name, labels)] = totals.get((name, labels), 0) + int(t[0])
        for (name, labels), v in totals.items():
            self.metrics.counter(name, **dict(labels)).value = float(v)

    def export_jsonl(self, path) -> int:
        """Write events + metrics + spans as a JSONL log; returns #lines."""
        self.settle()
        return write_jsonl(path, registry=self.metrics, tracer=self.tracer,
                           events=self.events)

    def prometheus(self) -> str:
        self.settle()
        return prometheus_text(self.metrics)

    def dashboard(self, width: int = 60) -> str:
        self.settle()
        return dashboard(self.metrics, width=width)


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


class _Off:
    """A span's context while nothing records: enters to ``None``."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span's context while the profiler records or a session is open."""

    __slots__ = ("name", "attrs", "_range", "_tracer", "_span")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        tel = active()
        self._tracer = None if tel is None else tel.tracer
        self._span = None if tel is None else self._tracer.open(self.name, self.attrs)
        return self._span

    def __exit__(self, *exc):
        if self._span is not None:
            self._tracer.close(self._span)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context over one phase named ``name``: a ``record_function`` range while the
    profiler records, a node of the active session's span tree (entered as the open
    :class:`Span`) while one is open, and a shared no-op entering as ``None`` else."""
    if not _STACK and not _profiler_enabled():
        return _OFF
    return _On(name, attrs)


def counter(name: str, value: float = 1.0, **labels) -> None:
    """Increment a counter in the active session; no-op when disabled."""
    tel = active()
    if tel is not None:
        tel.metrics.counter(name, **labels).inc(value)


def device_counter(name: str, device, size: int = 1, **labels):
    """The active session's device tensor for counter ``name`` (see
    :meth:`Telemetry.device_counter`), or ``None`` when disabled."""
    tel = active()
    return None if tel is None else tel.device_counter(name, device, size, **labels)


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
