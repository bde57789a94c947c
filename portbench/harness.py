"""The benchmark's harness: one cell's set-up, measured window and check.

Everything a cell needs is found by name from ``BENCHMARK.json``: its configuration's
file (sizes and settings), ``traffic/<traffic>.json`` (the mix's parameters, read by
one of the two loops below, named by the file's ``loop``), ``limits/<workload>.json``
(the limit of each number that decides ``correct``) and ``metrics/<metric>.py`` (a
reader of each metric the cell reports). A later cell or metric is added as files
and entries; no code here names a cell.

The two loops:

* ``stream``: a surveillance service. Several assets, each with its own trained model
  and detector calibration, take turns in a closed loop of one stream that keeps
  ``ahead`` batches queued beyond the one the host waits on; each asset's batches come
  from a pool made at set-up. Each batch is standardized, estimated and run through the
  SPRT, and its alarms and LLRs are copied to pinned host memory on a second stream. A
  batch's latency runs from its submission on the host to its copy being complete.
* ``cells``: Monte Carlo scoping. Each cell trains a model on one pool entry's
  training observations, estimates the rest and synchronizes, as the port's
  ``run_measured`` times a cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import random
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import clocks, reference, telemetry
from portbench import trace as tracing
from portbench.system import SYSTEMS

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


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


def load_cell(name: str, bench: dict | None = None) -> Cell:
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
        config=read_json(REPO / conf["file"]),
        traffic=read_json(ROOT / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(ROOT / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
    )


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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
    units: int = 0  # batches or cells completed in the window
    unit_obs: int = 0  # observations a unit
    window_s: float = math.nan  # host clock, first submission to last completion
    latencies_ms: list = field(default_factory=list)
    intervals_ms: list = field(default_factory=list)  # completion to completion
    timers_ms: dict = field(default_factory=dict)  # CUDA-event times a unit, traced runs
    trace: object = None
    checks: dict = field(default_factory=dict)
    clocks: dict = field(default_factory=dict)
    card: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0


# ---------------------------------------------------------------- the stream loop


class Stream:
    def __init__(self, run: Run, dev: Device, sut, cell: Cell):
        self.run, self.dev, self.sut = run, dev, sut
        self.cfg, self.tr = cell.config, cell.traffic

    def asset(self, a: int):
        """Asset ``a``'s telemetry -> (training observations, validation batch, pool)."""
        cfg, tr, seed = self.cfg, self.tr, self.run.seed
        B, n_tr, P = cfg["surveil_batch"], cfg["n_train"], tr["pool"]
        X = telemetry.series(seed, n_tr + B * (1 + P), cfg["n_signals"], cfg["telemetry"],
                             self.dev.dev, part=a)
        scale = torch.std(X[:n_tr], dim=0)
        valid = X[n_tr : n_tr + B].clone()
        pool = []
        for i in range(P):
            x = X[n_tr + B * (1 + i) : n_tr + B * (2 + i)].clone()
            part = 1000 * (a + 1) + i
            pool.append(telemetry.add_faults(x, seed, part, tr["fault_share"], tr["fault_sigmas"], scale))
        return X[:n_tr].clone(), valid, pool

    def setup(self):
        """Each asset's data, model and detector calibration (the residuals' mean and
        standard deviation on a clean validation batch), then the host buffers and the
        warm-up; -> the warm-up's seconds a batch."""
        cfg, tr, dev, run = self.cfg, self.tr, self.dev, self.run
        no_span = lambda name: tracing.span(name, False)  # noqa: E731
        self.sut.prepare(cfg)
        self.models, self.sigmas, self.mus, self.valids, self.pools = [], [], [], [], []
        run.phases.update(data_s=0.0, train_s=0.0)
        for a in range(tr["assets"]):
            t = time.perf_counter()
            X, valid, pool = self.asset(a)
            dev.sync()
            run.phases["data_s"] += time.perf_counter() - t
            t = time.perf_counter()
            model = self.sut.train(X, cfg, no_span)
            del X
            r = self.sut.estimate(model, valid, no_span)
            self.sigmas.append(torch.std(r, dim=0, correction=0))
            self.mus.append(torch.mean(r, dim=0))
            del r
            self.models.append(model)
            self.valids.append(valid)
            self.pools.append(pool)
            dev.sync()
            run.phases["train_s"] += time.perf_counter() - t

        t = time.perf_counter()
        self.ring = [self._buffers() for _ in range(tr["ahead"] + 1)]
        self.kept = {k: self._buffers() for k in range(tr["samples"])}
        run.phases["host_buffers_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.window(batches=tr["warmup_batches"], measure=False)
        run.phases["warmup_s"] = time.perf_counter() - t
        return run.phases["warmup_s"] / tr["warmup_batches"]

    def where(self, k: int) -> tuple[int, int]:
        """Batch ``k``'s asset and its place in that asset's pool: the stream takes the
        assets in turn."""
        A = len(self.pools)
        return k % A, (k // A) % len(self.pools[0])

    def _buffers(self):
        B, n = self.cfg["surveil_batch"], self.cfg["n_signals"]
        return self.dev.host((B, n), torch.bool), self.dev.host((B, 2, n), torch.float32)

    def window(self, seconds=None, batches=None, measure=True, samples=()):
        """Serve batches until ``seconds`` have passed or ``batches`` were submitted, then
        drain; with ``measure`` the run's window, latencies and timers are recorded."""
        dev, run, sut = self.dev, self.run, self.sut
        traced = run.traced and measure
        depth = self.tr["ahead"] + 1
        targets = {k: self.kept[i] for i, k in enumerate(samples)}
        self.sampled = {}
        inflight: deque = deque()
        sub, done_t, timers = [], [], []
        t_start = time.perf_counter()
        t_end = t_start + seconds if seconds is not None else math.inf
        k = 0
        while True:
            while len(inflight) < depth and time.perf_counter() < t_end and (
                batches is None or k < batches
            ):
                a, i = self.where(k)
                sub.append(time.perf_counter())
                ev0 = dev.timer() if traced else None
                with tracing.span("estimate", traced):
                    r = sut.estimate(self.models[a], self.pools[a][i], lambda n: tracing.span(n, traced))
                ev1 = dev.timer() if traced else None
                with tracing.span("sprt", traced):
                    alarms, llr = sut.sprt(r, self.sigmas[a], self.mus[a])
                ev2 = dev.timer() if traced else None
                del r
                dst = targets.get(k, self.ring[k % depth])
                with tracing.span("copy", traced):
                    handle = dev.to_host((alarms, llr), dst)
                del alarms, llr
                if k in targets:
                    self.sampled[k] = dst
                inflight.append(handle)
                if traced:
                    timers.append((ev0, ev1, ev2))
                k += 1
            if not inflight:
                break
            handle = inflight.popleft()
            if handle is not None:
                handle.synchronize()
            done_t.append(time.perf_counter())
        if not self.sampled and k:  # a window too short for its samples keeps its last batch
            self.sampled[k - 1] = self.ring[(k - 1) % depth]
        self.last_intervals = [(b - a) * 1e3 for a, b in zip(done_t, done_t[1:])]
        if measure:
            run.units = k
            run.unit_obs = self.cfg["surveil_batch"]
            run.window_s = done_t[-1] - t_start
            run.latencies_ms = [(d - s) * 1e3 for s, d in zip(sub, done_t)]
            run.intervals_ms = self.last_intervals
            if traced:
                dev.sync()
                run.timers_ms = {
                    "estimate": [dev.elapsed_ms(a, b) for a, b, _ in timers],
                    "sprt": [dev.elapsed_ms(b, c) for _, b, c in timers],
                }

    def free(self):
        self.models = self.sigmas = self.mus = self.ring = None

    def check(self) -> dict:
        """Each sampled batch's alarms and LLRs against the reference's, which trains its
        own model of the batch's asset and calibrates its own detector."""
        cfg, dev = self.cfg, self.dev
        s = cfg["sprt"]
        upper, lower = reference.sprt_bounds(s["alpha"], s["beta"])
        refs = {}
        worst = {"alarm_diff": 0.0, "llr_gap": 0.0, "llr_widest": 0.0}
        for k, (alarms, llr) in sorted(self.sampled.items()):
            a, i = self.where(k)
            if a not in refs:
                X = self.asset(a)[0]
                ref = reference.train(X, cfg["n_memvec"], cfg["kind"], cfg["reg"])
                del X
                r = reference.estimate(ref, self.valids[a])
                refs = {a: (ref, torch.std(r, dim=0, correction=0), torch.mean(r, dim=0))}
            ref, sigma, mu = refs[a]
            r = reference.estimate(ref, self.pools[a][i])
            a_ref, l_ref = reference.sprt(r, sigma, mu, s["m_shift"], upper, lower)
            del r
            got, l = alarms.to(dev.dev), llr.to(dev.dev).to(l_ref.dtype)
            g = (l - l_ref).abs()
            free = l_ref > lower
            now = {
                "alarm_diff": float((got != a_ref).double().mean()),
                "llr_gap": float(torch.median(g[free])) if bool(free.any()) else 0.0,
                "llr_widest": float(g.max()),
            }
            if not bool(torch.isfinite(l).all()):
                now["llr_gap"] = math.inf
            worst = {key: max(v, now[key]) for key, v in worst.items()}
        worst["checked"] = len(self.sampled)
        return worst


# ---------------------------------------------------------------- the scoping loop


class Cells:
    def __init__(self, run: Run, dev: Device, sut, cell: Cell):
        self.run, self.dev, self.sut = run, dev, sut
        self.cfg, self.tr = cell.config, cell.traffic

    def setup(self):
        cfg, tr, dev, run = self.cfg, self.tr, self.dev, self.run
        t = time.perf_counter()
        rows = cfg["n_train"] + cfg["n_observations"]
        self.pool = [
            telemetry.series(run.seed, rows, cfg["n_signals"], cfg["telemetry"], dev.dev, part=i)
            for i in range(tr["pool"])
        ]
        dev.sync()
        run.phases["data_s"] = time.perf_counter() - t
        self.sut.prepare(cfg)
        t = time.perf_counter()
        self.window(cells=tr["warmup_cells"], measure=False)
        run.phases["warmup_s"] = time.perf_counter() - t
        return run.phases["warmup_s"] / tr["warmup_cells"]

    def window(self, seconds=None, cells=None, measure=True, samples=()):
        dev, run, sut, cfg = self.dev, self.run, self.sut, self.cfg
        traced = run.traced and measure
        n_tr, P = cfg["n_train"], len(self.pool)
        span = lambda name: tracing.span(name, traced)  # noqa: E731
        self.sampled, times, train_s = {}, [], []
        t_start = time.perf_counter()
        t_end = t_start + seconds if seconds is not None else math.inf
        k = 0
        while (cells is None or k < cells) and (k == 0 or time.perf_counter() < t_end):
            X = self.pool[k % P]
            t = time.perf_counter()
            with tracing.span("cell", traced):
                if traced:  # the traced run alone splits the cell at a synchronize
                    dev.sync()
                    a = time.perf_counter()
                    model = sut.train(X[:n_tr], cfg, span)
                    dev.sync()
                    train_s.append(time.perf_counter() - a)
                else:
                    model = sut.train(X[:n_tr], cfg, span)
                r = sut.estimate(model, X[n_tr:], span)
                dev.sync()
            times.append(time.perf_counter() - t)
            if k in samples:
                self.sampled[k] = r
            del model, r
            k += 1
        self.last_intervals = [s * 1e3 for s in times]
        if measure:
            run.units = k
            run.unit_obs = cfg["n_observations"]
            run.window_s = time.perf_counter() - t_start
            run.intervals_ms = self.last_intervals
            if traced:
                run.timers_ms = {"train": [s * 1e3 for s in train_s]}

    def free(self):
        pass

    def check(self) -> dict:
        """Each sampled cell's residuals against the reference's, in units of the
        reference residuals' standard deviation, signal by signal."""
        cfg, dev = self.cfg, self.dev
        n_tr, P = cfg["n_train"], len(self.pool)
        gap, refs = 0.0, {}
        for k, r in sorted(self.sampled.items()):
            j = k % P
            if j not in refs:
                X = self.pool[j]
                ref = reference.train(X[:n_tr], cfg["n_memvec"], cfg["kind"], cfg["reg"])
                refs = {j: reference.estimate(ref, X[n_tr:])}
                del ref
            r_ref = refs[j]
            sigma = torch.std(r_ref, dim=0, correction=0)
            g = float(((r.to(r_ref.dtype) - r_ref).abs() / sigma).max())
            gap = max(gap, g if math.isfinite(g) else math.inf)
        return {"resid_gap": gap, "checked": len(self.sampled)}


LOOPS = {"stream": Stream, "cells": Cells}


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
    sut = sut if sut is not None else SYSTEMS["port"]()
    r = Run(cell, seed, traced)
    if dev.cuda:
        r.card = clocks.card()
    loop = LOOPS[cell.traffic["loop"]](r, dev, sut, cell)
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
    t = time.perf_counter()
    r.checks = loop.check()
    r.phases["check_s"] = time.perf_counter() - t
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
