"""The traced run: spans from the benchmark's own files, and the device's timeline from
``torch.profiler``, read straight from the profiler's raw events (no tables built).

A span is a ``record_function`` range named ``bench.<what>`` around a call into a
layer of the program. ``Trace`` holds, for the traced window only, every device
operation (kernels, copies, fills) with the host time of the operator that launched
it, and every host event, so that a metric's reader can sum device time by kernel
name or by the host range that launched it.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"


def span(name: str, on: bool):
    """A ``bench.<name>`` range in the trace when ``on``, nothing otherwise."""
    return torch.profiler.record_function(f"bench.{name}") if on else contextlib.nullcontext()


def _call(ev, name):
    v = getattr(ev, name)
    return v() if callable(v) else v


@dataclass
class DeviceOp:
    name: str
    start: int  # ns
    end: int  # ns
    launch: int | None  # ns: the start of the host operator that launched it


@dataclass
class HostEvent:
    name: str
    start: int
    end: int
    user: bool  # a record_function range


@dataclass
class Trace:
    window: tuple[int, int]  # ns, the bench.window range
    ops: list[DeviceOp] = field(default_factory=list)
    host: list[HostEvent] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the window."""
        lo, hi = self.window
        out: list[list[int]] = []
        for s, e in sorted((max(o.start, lo), min(o.end, hi)) for o in self.ops):
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_s(self, pattern: str) -> float:
        """Seconds of device operations whose names match ``pattern`` (a regex, any case)."""
        rx = re.compile(pattern, re.IGNORECASE)
        return sum(o.end - o.start for o in self.ops if rx.search(o.name)) * 1e-9

    def device_s_under(self, pattern: str) -> float:
        """Seconds of device operations launched inside a host event whose name matches
        ``pattern`` (a span or an operator, nested or not)."""
        rx = re.compile(pattern, re.IGNORECASE)
        ranges = sorted((h.start, h.end) for h in self.host if rx.search(h.name))
        merged: list[list[int]] = []
        for s, e in ranges:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [s for s, _ in merged]
        total = 0
        for o in self.ops:
            if o.launch is None:
                continue
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and o.launch <= merged[i][1]:
                total += o.end - o.start
        return total * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle gaps summed
        by what the host was doing when each began."""
        by_name: dict[str, int] = defaultdict(int)
        for o in self.ops:
            by_name[o.name[:96]] += o.end - o.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: dict[str, list[int]] = defaultdict(lambda: [0, 0])
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        host = sorted((h for h in self.host if h.name != WINDOW), key=lambda h: h.start)
        users = [h for h in host if h.user]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                g = gaps[_doing(host, users, s)]
                g[0] += e - s
                g[1] += 1
        idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:top]
        return {
            "device_ops": [[n, t * 1e-9] for n, t in ops],
            "idle_gaps": [[f"{n} ({c} gaps)", t * 1e-9] for n, (t, c) in idle],
        }


def _covering(events, t, back: int):
    """Events among the ``back`` latest to start at or before ``t`` that still run at ``t``."""
    i = bisect.bisect_right(events, t, key=lambda h: h.start)
    return [h for h in events[max(0, i - back) : i] if h.end >= t]


def _doing(host, users, t) -> str:
    """The outermost span and the innermost host event that hold time ``t``."""
    inner = _covering(host, t, 256)
    outer = _covering(users, t, 64)
    if not inner and not outer:
        return "no host event"
    name = max(inner, key=lambda h: h.start).name if inner else ""
    top = min(outer, key=lambda h: h.start).name if outer else ""
    return f"{top}: {name}" if top and name and top != name else (name or top)


def read(prof) -> Trace:
    """The traced window's device operations and host events from a stopped
    ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    host: list[HostEvent] = []
    op_start: dict[int, int] = {}
    device = []
    window = None
    for ev in events:
        name = _call(ev, "name")
        start = _call(ev, "start_ns")
        end = start + _call(ev, "duration_ns")
        user = bool(_call(ev, "is_user_annotation"))
        if _call(ev, "device_type") == torch.autograd.DeviceType.CPU:
            if name == WINDOW:
                window = (start, end)
            host.append(HostEvent(name, start, end, user))
            cid = _call(ev, "correlation_id")
            if cid and not _call(ev, "linked_correlation_id"):
                op_start[cid] = start
        elif not user and not name.startswith("bench."):  # a span's copy on the device
            device.append((name, start, end, _call(ev, "linked_correlation_id")))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    lo, hi = window
    ops = [DeviceOp(n, s, e, op_start.get(c)) for n, s, e, c in device if e > lo and s < hi]
    host = [h for h in host if h.end >= lo and h.start <= hi]
    return Trace(window, ops, host)
