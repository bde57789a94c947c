"""The ``cells`` loop: Monte Carlo scoping.

Each cell trains a model on one pool entry's training observations, estimates the rest
and synchronizes, as the port's ``run_measured`` times a cell. A unit is a cell.

The check holds each sampled cell's residuals to ``portbench/reference.py``.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import reference, telemetry
from portbench import trace as tracing
from portbench.harness import Cell, Device, Run


class Loop:
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
        cfg = self.cfg
        n_tr, P = cfg["n_train"], len(self.pool)
        gap, held = 0.0, None  # (pool entry, its reference residuals): one at a time
        for k, r in sorted(self.sampled.items()):
            j = k % P
            if held is None or held[0] != j:
                held = r_ref = None  # freed before the next entry's are made
                X = self.pool[j]
                ref = reference.train(X[:n_tr], cfg["n_memvec"], cfg["kind"], cfg["reg"])
                held = (j, reference.estimate(ref, X[n_tr:]))
                del ref
            r_ref = held[1]
            sigma = torch.std(r_ref, dim=0, correction=0)
            g = float(((r.to(r_ref.dtype) - r_ref).abs() / sigma).max())
            gap = max(gap, g if math.isfinite(g) else math.inf)
        return {"resid_gap": gap, "checked": len(self.sampled)}
