"""Drift probe: MSET+SPRT residual monitoring over fleet telemetry streams —
the observation half of the ROADMAP "closed-loop autonomous control (drift →
re-scope → re-tune)" item.

The paper's prognostic engine watches the running container's telemetry and
alarms when it leaves the predicted envelope. Here the envelope is learned
from a *baseline* simulation's metric streams (observed per-bin service
times, queue depth, utilization): :class:`DriftProbe` trains an MSET
similarity model (``repro_torch.mset``) on the baseline matrix, then runs a Wald
SPRT (``repro_torch.mset.sprt``) over the standardized residuals of any later
observation window. A fleet whose service model has silently degraded (the
injected drift scenario: slower per-batch times under the same policy and
trace) produces residuals whose mean shifts by several sigma, tripping the
SPRT within a few bins — while a fresh unperturbed replicate stays quiet.

This is deliberately *probe only*: it flags drift and reports when; acting
on the flag (re-scope, re-tune) is :mod:`repro_torch.fleet.control`'s job.

The model and the SPRT run on ``device`` (``None`` means the card, raising
when there is none): the similarity operator and the SPRT recursion are the
port's CUDA kernels there, their plain versions on the CPU. The dtypes follow
the reference, which runs in float32: observations reach MSET2 as float32, so
its residuals are float32; the calibration mean and spread are taken in numpy
float64 of those residuals, and reach the SPRT rounded to float32.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.mset import SPRTParams, estimate, sprt, train

# Streams the probe monitors, in matrix column order.
DEFAULT_SIGNALS = ("service_time_s", "utilization", "queue_depth")

_SIGMA_FLOOR = 1e-4


def telemetry_matrix(sim, signals=DEFAULT_SIGNALS) -> np.ndarray:
    """(T, n_signals) observation matrix from a ``SimResult`` — the same
    per-bin seed-mean streams ``record_sim`` emits, assembled directly so the
    probe works on bare results without an active session."""
    from repro_torch.fleet.telemetry.metrics import service_time_stream

    cols = []
    for sig in signals:
        if sig == "service_time_s":
            cols.append(service_time_stream(sim))
        elif sig == "utilization":
            cols.append(np.asarray(sim.utilization, float).mean(axis=0))
        elif sig == "queue_depth":
            cols.append(np.asarray(sim.queue, float).mean(axis=0))
        elif sig == "arrival_rate":
            cols.append(np.asarray(sim.arrivals, float).mean(axis=0)
                        / sim.dt_s)
        elif sig == "replicas":
            cols.append(np.asarray(sim.replicas, float).mean(axis=0))
        else:
            raise ValueError(f"unknown drift signal {sig!r}; expected one of "
                             "service_time_s, utilization, queue_depth, "
                             "arrival_rate, replicas")
    return np.stack(cols, axis=1)


def degrade_fleet(fleet, factor: float):
    """The injected-drift scenario: the same fleet with every pool's service
    times inflated by ``factor`` (slower fixed overhead *and* per-unit time —
    a node whose effective throughput has silently decayed). ``factor=1`` is
    the identity."""
    from dataclasses import replace

    pools = tuple(
        replace(p, service=replace(p.service,
                                   t_fixed=p.service.t_fixed * factor,
                                   t_per_unit=p.service.t_per_unit * factor))
        for p in fleet.pools)
    return replace(fleet, pools=pools)


@dataclass
class DriftReport:
    """Verdict of one :meth:`DriftProbe.check` window."""
    drifted: bool
    first_alarm_bin: int            # -1 when quiet
    alarm_bins: int                 # bins with >= 1 signal alarming
    alarm_fraction: float           # alarmed (bin, signal) cells / total
    per_signal_alarms: dict         # signal name -> alarmed bin count
    n_bins: int
    signals: tuple

    def summary(self) -> str:
        verdict = "DRIFT" if self.drifted else "ok"
        parts = ", ".join(f"{k}={v}" for k, v in
                          self.per_signal_alarms.items())
        where = (f" first at bin {self.first_alarm_bin}"
                 if self.first_alarm_bin >= 0 else "")
        return (f"[{verdict}] {self.alarm_bins}/{self.n_bins} bins alarmed"
                f"{where} ({parts})")


@dataclass
class DriftProbe:
    """MSET+SPRT residual monitor over fleet telemetry.

    ``fit`` learns the envelope from a baseline ``SimResult``; ``check``
    scores an observation window (another ``SimResult`` or a raw (T, n)
    matrix) and returns a :class:`DriftReport`. ``min_alarm_bins`` is the
    persistence filter: one stray SPRT trip is noise, a run of them is
    drift. ``device`` is where the model trains and the SPRT runs (``None``:
    the card)."""
    signals: tuple = DEFAULT_SIGNALS
    n_memvec: int = 48
    sprt_params: SPRTParams = field(
        default_factory=lambda: SPRTParams(alpha=1e-4, beta=1e-4,
                                           m_shift=4.0))
    min_alarm_bins: int = 8
    # held-out calibration rows still share the baseline's Monte Carlo
    # draws, so their residual spread underestimates the noise of a truly
    # fresh replicate window; widen the envelope by this factor
    sigma_scale: float = 2.0
    model: object = field(default=None, repr=False)
    sigma: np.ndarray = field(default=None, repr=False)
    mu: np.ndarray = field(default=None, repr=False)
    device: object = None

    def fit(self, baseline, signals=None) -> "DriftProbe":
        """Train on a baseline ``SimResult`` (or (T, n) matrix): build the
        MSET memory matrix and calibrate the residual scale the SPRT
        standardizes against.

        Calibration is held out: MSET trains on the even-indexed bins and the
        residual mean/std come from the odd-indexed bins. In-sample residuals
        are near zero (the memory matrix reconstructs its own training data),
        so calibrating on them makes *any* fresh replicate look like a
        multi-sigma shift — the held-out split measures honest out-of-sample
        reconstruction noise across the whole operating envelope."""
        if signals is not None:
            self.signals = tuple(signals)
        X = self._matrix(baseline)
        fit_rows, cal_rows = X[0::2], X[1::2]
        if len(cal_rows) < 8:           # too short to split; fall back
            fit_rows = cal_rows = X
        self.model = train(self._f32(fit_rows),
                           min(self.n_memvec, fit_rows.shape[0]))
        _, resid = estimate(self.model, self._f32(cal_rows))
        resid = resid.cpu().numpy().astype(float)
        self.mu = resid.mean(axis=0)
        self.sigma = np.maximum(resid.std(axis=0) * self.sigma_scale,
                                _SIGMA_FLOOR)
        return self

    def check(self, observed) -> DriftReport:
        """Score an observation window against the fitted envelope."""
        if self.model is None:
            raise RuntimeError("DriftProbe.check before fit()")
        X = self._matrix(observed)
        _, resid = estimate(self.model, self._f32(X))
        alarms, _, _ = sprt(resid, self._f32(self.sigma), self.sprt_params,
                            mu=self._f32(self.mu))
        a = alarms.cpu().numpy().astype(bool)   # (T, n)
        bin_alarm = a.any(axis=1)
        alarm_bins = int(bin_alarm.sum())
        drifted = alarm_bins >= self.min_alarm_bins
        first = int(np.argmax(bin_alarm)) if alarm_bins else -1
        per_sig = {sig: int(a[:, j].sum())
                   for j, sig in enumerate(self.signals)}
        report = DriftReport(
            drifted=drifted, first_alarm_bin=first, alarm_bins=alarm_bins,
            alarm_fraction=float(a.mean()), per_signal_alarms=per_sig,
            n_bins=int(a.shape[0]), signals=tuple(self.signals))
        self._emit(report)
        return report

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=resolve_device(self.device))

    def _matrix(self, obj) -> np.ndarray:
        if isinstance(obj, np.ndarray):
            X = np.asarray(obj, float)
            if X.ndim != 2 or X.shape[1] != len(self.signals):
                raise ValueError(f"expected (T, {len(self.signals)}) matrix, "
                                 f"got shape {X.shape}")
            return X
        return telemetry_matrix(obj, self.signals)

    def _emit(self, report: DriftReport) -> None:
        from repro_torch.fleet import telemetry

        telemetry.counter("fleet_drift_checks_total",
                          verdict="drift" if report.drifted else "ok")
        telemetry.event("drift_check", drifted=report.drifted,
                        first_alarm_bin=report.first_alarm_bin,
                        alarm_bins=report.alarm_bins,
                        n_bins=report.n_bins,
                        alarm_fraction=report.alarm_fraction)
