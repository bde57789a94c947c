"""The benchmark's harness: one cell's set-up, measured window and check.

Everything a cell needs is found by name from ``BENCHMARK.json``: its configuration's
file (sizes and settings, and the ``system`` it runs), ``traffic/<traffic>.json`` (the
mix's parameters and the ``loop`` that reads them), ``limits/<workload>.json`` (the
limit of each number that decides ``correct``) and ``metrics/<metric>.py`` (a reader of
each metric the cell reports). A later cell, metric, loop or system is added as files
and entries; no code here names one.

The contract for what is added as files:

* A loop, ``loops/<loop>.py`` (the traffic file's ``loop``), defines
  ``Loop(run, dev, sut, cell)``: ``run`` a ``Run``, ``dev`` a ``Device``, ``sut`` the
  system's ``port`` or ``control`` as built, ``cell`` a ``Cell``. It gives

  - ``setup() -> float``: the cell's data, the system's preparation and a warm-up of
    every shape the window uses; returns the warm-up's seconds a unit (a batch, a
    cell, a request: what the loop completes one at a time);
  - ``window(seconds=None, samples=(), measure=True, ...)``: units until ``seconds``
    have passed, with ``samples`` (unit indices) kept for the check; the loop's own
    keyword for a count of units (``batches``, ``cells``) and ``measure=False`` serve
    its warm-up. With ``measure`` it fills the run's ``units`` (completed in the
    window), ``unit_obs`` (observations, rows or tokens a unit), ``window_s`` (host
    clock, first submission to last completion), ``latencies_ms`` (a unit's
    submission to its completion, where a unit has a latency), ``intervals_ms``
    (completion to completion) and, in a traced run, ``timers_ms`` (name -> times a
    unit);
  - ``free()``: drops what only the window needed, before the check;
  - ``check() -> dict``: each number that the cell's limits file limits, and
    ``checked``, how many answers were compared.

  The end-to-end readers read only those fields: ``obs_per_s`` is units x unit_obs /
  window_s, ``p95_ms`` is taken over ``latencies_ms`` and ``cell_s`` is window_s /
  units. A loop that fills them reports those metrics with no reader changed. A loop's
  plain reference lives in a module of its own beside the loops (``reference.py`` for
  ``stream`` and ``cells``), plain PyTorch or NumPy that imports nothing of the program.
* A system, ``systems/<system>.py`` (the configuration file's ``system``; a file
  without the key is ``UNNAMED_SYSTEM``'s), defines ``SYSTEMS = {"port": ...,
  "control": ...}``: the classes the loop drives, the program under test (imported
  only when built) and the control, the reference in the precision below the
  configuration's, with the one interface that the system's loops call.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import clocks, telemetry
from portbench import trace as tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
UNNAMED_SYSTEM = "mset2"  # the system of configuration files that predate the key


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = ROOT  # where its loop and system are found

    @property
    def system(self) -> str:
        return self.config.get("system", UNNAMED_SYSTEM)


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """Workload ``name`` of ``bench`` (``BENCHMARK.json``), its files found under ``root``
    and its configuration's ``file`` under ``root``'s parent."""
    bench = bench if bench is not None else read_json(REPO / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(m):
        return name in m.get("workloads", [name])

    return Cell(
        name=name,
        chips=w["chips"],
        config=read_json(root.parent / conf["file"]),
        traffic=read_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(root / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
        root=root,
    )


def _module(root: Path, kind: str, name: str):
    """``<root>/<kind>/<name>.py``, loaded from its file."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
    return _module(ROOT, "metrics", metric).read


def systems(cell: Cell) -> dict:
    """The cell's system's ``SYSTEMS``: ``{"port": class, "control": class}``."""
    return _module(cell.root, "systems", cell.system).SYSTEMS


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (``names``: ``sys.modules``) whose top-level name, compared whole, is
    JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


class Device:
    """What the loops need of the device: CUDA streams, events and pinned memory on
    the card, and their synchronous stand-ins on the CPU (the tests' device)."""

    def __init__(self, device: str):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.copy_stream = torch.cuda.Stream(self.dev) if self.cuda else None

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def host(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def timer(self):
        """An event on the compute stream whose time can be read after a sync."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def elapsed_ms(a, b) -> float:
        return a.elapsed_time(b) if not isinstance(a, float) else (b - a) * 1e3

    def to_host(self, tensors, targets):
        """Copy device ``tensors`` into host ``targets`` behind the compute stream's
        current work; -> a handle whose ``synchronize`` waits for the copies."""
        if not self.cuda:
            for t, d in zip(tensors, targets):
                d.copy_(t)
            return None
        ready = torch.cuda.Event()
        ready.record()
        self.copy_stream.wait_event(ready)
        with torch.cuda.stream(self.copy_stream):
            for t, d in zip(tensors, targets):
                d.copy_(t, non_blocking=True)
                t.record_stream(self.copy_stream)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        return done


@dataclass
class Run:
    """What a run measured; the metrics' readers take it."""

    cell: Cell
    seed: int
    traced: bool
    setup_s: float = math.nan
    phases: dict = field(default_factory=dict)
    units: int = 0  # units (batches, cells) completed in the window
    unit_obs: int = 0  # observations a unit
    window_s: float = math.nan  # host clock, first submission to last completion
    latencies_ms: list = field(default_factory=list)
    intervals_ms: list = field(default_factory=list)  # completion to completion
    timers_ms: dict = field(default_factory=dict)  # CUDA-event times a unit, traced runs
    trace: object = None
    checks: dict = field(default_factory=dict)
    clocks: dict = field(default_factory=dict)
    card: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0  # the window's
    check_peak_bytes: int = 0


def draw_samples(seed: int, expected_units: int, count: int) -> list[int]:
    """``count`` distinct unit indices drawn from the seed among the first four fifths of
    the units a window is expected to complete."""
    span = max(int(0.8 * expected_units), 1)
    rng = random.Random(telemetry.sub_seed(seed, 1 << 20))
    return sorted(rng.sample(range(span), min(count, span)))


def run(cell: Cell, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        sut=None, t0: float | None = None, out_dir: Path | None = None) -> Run:
    """Set up, measure and check one cell; -> the ``Run``, its checks filled in."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = Device(device)
    sut = sut if sut is not None else systems(cell)["port"]()
    r = Run(cell, seed, traced)
    if dev.cuda:
        r.card = clocks.card()
    loop = _module(cell.root, "loops", cell.traffic["loop"]).Loop(r, dev, sut, cell)
    per_unit_s = loop.setup()  # the warm-up's seconds a unit
    samples = draw_samples(seed, int(seconds / per_unit_s), cell.traffic["samples"])
    dev.sync()
    r.setup_s = time.perf_counter() - t0
    if dev.cuda:  # the peak of the window's own work
        torch.cuda.reset_peak_memory_stats(dev.dev)
    prof = None
    if traced:
        act = [torch.profiler.ProfilerActivity.CPU]
        if dev.cuda:
            act.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=act)
    out = (out_dir or ROOT / "_out") / cell.name
    sampler = clocks.Sampler(out / f"seed{seed}-trace{int(traced)}.clock.csv") if dev.cuda else None
    with sampler or contextlib.nullcontext(), prof or contextlib.nullcontext():
        with tracing.span("window", traced):
            loop.window(seconds=seconds, samples=samples)
        dev.sync()
    if sampler is not None:
        r.clocks = sampler.summary()
    if prof is not None:
        t = time.perf_counter()
        r.trace = tracing.read(prof)
        del prof
        r.phases["trace_read_s"] = time.perf_counter() - t
    r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev.dev) if dev.cuda else 0
    loop.free()
    if dev.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev.dev)
    t = time.perf_counter()
    r.checks = loop.check()
    r.phases["check_s"] = time.perf_counter() - t
    if dev.cuda:
        r.check_peak_bytes = torch.cuda.max_memory_allocated(dev.dev)
    return r


def verdict(r: Run) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit; a run that checked no
    answer is not correct."""
    limits = r.cell.limits["limits"]
    shown = {k: {"value": r.checks[k], "limit": v} for k, v in limits.items()}
    ok = r.checks.get("checked", 0) > 0 and all(
        math.isfinite(r.checks[k]) and r.checks[k] <= v for k, v in limits.items())
    return ok, shown


def result(r: Run, device_name: str, count: int) -> dict:
    metrics = {}
    for m in (r.cell.per_layer if r.traced else r.cell.end_to_end):
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, shown = verdict(r)
    device = {
        "platform": "gpu",
        "kind": device_name,
        "count": count,
        "memory_peak_bytes": int(r.memory_peak_bytes),
    }
    if r.card:
        device["power_limit_w"] = r.card.get("power_limit_w")
    out = {"correct": ok, "attempted": r.units, "failed": 0, "metrics": metrics, "device": device}
    if r.traced and r.trace is not None:
        device["busy_s"] = r.trace.busy_s
        device["window_s"] = r.trace.window_s
        out["breakdown"] = r.trace.breakdown()
    out["checks"] = shown
    return out
