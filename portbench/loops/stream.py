"""The ``stream`` loop: a surveillance service.

Several assets, each with its own trained model and detector calibration, take turns in
a closed loop of one stream that keeps ``ahead`` batches queued beyond the one the host
waits on; each asset's batches come from a pool made at set-up. Each batch is
standardized, estimated and run through the SPRT, and its alarms and LLRs are copied to
pinned host memory on a second stream. A batch's latency runs from its submission on
the host to its copy being complete. A unit is a batch.

The check holds each sampled batch to ``portbench/reference.py``.
"""

from __future__ import annotations

import math
import time
from collections import deque

import torch

from portbench import reference, telemetry
from portbench import trace as tracing
from portbench.harness import Cell, Device, Run


class Loop:
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
