"""Telemetry exporters: JSONL event log, Prometheus text exposition, and an
ASCII sparkline dashboard.

All three render the same :class:`~repro_torch.fleet.telemetry.metrics.MetricsRegistry`
(plus the span tracer and ad-hoc events for JSONL), so a session exports to
whichever sink fits: JSONL for machine-readable archives (the CI bench job
uploads one as an artifact), Prometheus text for scrape endpoints, the
dashboard for terminals.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.fleet.telemetry.metrics import MetricsRegistry

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
    from repro_torch.fleet.telemetry.metrics import label_str

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
    from repro_torch.fleet.telemetry.metrics import label_str
    ls = label_str(labels)
    return f"{name}{{{ls}}}" if ls else name
