"""Seeded synthetic request traces for the fleet simulator.

Each generator produces a deterministic rate profile lambda(t) (requests/s per
time bin) and Monte Carlo-samples Poisson arrival counts over ``n_seeds``
independent seeds — the fleet-level analogue of the paper's nested-loop Monte
Carlo over workload draws. The (n_seeds, n_bins) count array is what the
vectorized simulator consumes.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

_LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class Trace:
    """Monte Carlo arrival trace: ``arrivals[s, t]`` requests in bin t, seed s.

    ``base_rate`` (optional) is the pre-rescale rate profile: when a loader
    rescales a recorded trace to a target mean (``load_trace_csv``'s
    ``mean_rate_per_s=``), the raw profile is kept here so *shape* statistics
    (peak/mean burstiness, ramp sharpness — the scoping oracle's features)
    stay bit-identical to the recording instead of drifting by float rounding
    through the multiply. ``shape_profile`` is what feature extraction reads.
    """
    name: str
    dt_s: float
    rate: np.ndarray        # (n_bins,) expected requests/s per bin
    arrivals: np.ndarray    # (n_seeds, n_bins) sampled request counts
    base_rate: np.ndarray = None   # pre-rescale profile (None: rate is raw)

    @property
    def shape_profile(self) -> np.ndarray:
        """The profile shape statistics should be computed from: the
        pre-rescale recording when one exists, else the rate itself."""
        return self.rate if self.base_rate is None else self.base_rate

    @property
    def n_seeds(self) -> int:
        return self.arrivals.shape[0]

    @property
    def n_bins(self) -> int:
        return self.arrivals.shape[1]

    @property
    def duration_s(self) -> float:
        return self.n_bins * self.dt_s

    @property
    def peak_rate(self) -> float:
        return float(self.rate.max())

    @property
    def mean_rate(self) -> float:
        return float(self.rate.mean())


def _sample(name: str, rate: np.ndarray, dt_s: float, n_seeds: int,
            seed: int) -> Trace:
    rate = np.clip(np.asarray(rate, float), 0.0, None)
    rng = np.random.default_rng(seed)
    arrivals = rng.poisson(rate[None, :] * dt_s, size=(n_seeds, len(rate)))
    return Trace(name, dt_s, rate, arrivals)


def _bins(duration_s: float, dt_s: float) -> np.ndarray:
    n = max(int(round(duration_s / dt_s)), 1)
    return (np.arange(n) + 0.5) * dt_s


def poisson_trace(rate_per_s: float, duration_s: float, dt_s: float = 1.0,
                  n_seeds: int = 8, seed: int = 0) -> Trace:
    """Steady-state load: constant lambda."""
    t = _bins(duration_s, dt_s)
    return _sample("poisson", np.full(len(t), rate_per_s), dt_s, n_seeds, seed)


def diurnal_trace(mean_rate_per_s: float, duration_s: float, dt_s: float = 1.0,
                  amplitude: float = 0.8, period_s: float = 86400.0,
                  phase: float = 0.0, n_seeds: int = 8, seed: int = 0) -> Trace:
    """Day/night sinusoid: lambda(t) = mean * (1 + A sin(2*pi*t/period + phase))."""
    t = _bins(duration_s, dt_s)
    rate = mean_rate_per_s * (1.0 + amplitude * np.sin(2 * np.pi * t / period_s + phase))
    return _sample("diurnal", rate, dt_s, n_seeds, seed)


def flash_crowd_trace(base_rate_per_s: float, duration_s: float, dt_s: float = 1.0,
                      peak_mult: float = 8.0, t_burst_s: float = None,
                      burst_width_s: float = None, n_seeds: int = 8,
                      seed: int = 0) -> Trace:
    """Flash crowd: baseline with a Gaussian burst peaking at ``peak_mult`` x base."""
    t = _bins(duration_s, dt_s)
    t0 = duration_s / 2 if t_burst_s is None else t_burst_s
    w = duration_s / 12 if burst_width_s is None else burst_width_s
    rate = base_rate_per_s * (1.0 + (peak_mult - 1.0) * np.exp(-0.5 * ((t - t0) / w) ** 2))
    return _sample("flash-crowd", rate, dt_s, n_seeds, seed)


def ramp_trace(rate0_per_s: float, rate1_per_s: float, duration_s: float,
               dt_s: float = 1.0, n_seeds: int = 8, seed: int = 0) -> Trace:
    """Linear growth (e.g. a launch ramping to steady state)."""
    t = _bins(duration_s, dt_s)
    rate = rate0_per_s + (rate1_per_s - rate0_per_s) * t / duration_s
    return _sample("ramp", rate, dt_s, n_seeds, seed)


def replay_trace(rates_per_s, dt_s: float = 1.0, n_seeds: int = 8, seed: int = 0,
                 name: str = "replay", base_rate=None) -> Trace:
    """Replay a recorded per-bin rate profile (production traces, CSV columns...).
    ``base_rate`` carries the pre-rescale profile when ``rates_per_s`` was
    rescaled from a recording (see ``Trace.shape_profile``)."""
    tr = _sample(name, np.asarray(rates_per_s, float), dt_s, n_seeds, seed)
    if base_rate is None:
        return tr
    return Trace(tr.name, tr.dt_s, tr.rate, tr.arrivals,
                 base_rate=np.asarray(base_rate, float))


def resample_trace(trace: Trace, dt_s: float, seed: int = 0) -> Trace:
    """Split a recorded trace onto a finer time grid without re-sampling its
    Poisson draws.

    Each coarse bin's sampled count is distributed over ``k = trace.dt_s /
    dt_s`` fine bins by a seeded uniform multinomial — exactly the
    conditional law of a Poisson stream given its bin total, so the fine
    trace is a *refinement* of the same arrival realization, not a fresh
    draw: per-seed totals are conserved to the request, and two calls with
    the same ``seed`` split identically. This is what lets a coarse recorded
    replay (e.g. the 60-second Azure profile) drive a fine-Δt simulator core
    while staying paired with its coarse-core baseline.

    ``dt_s`` must divide ``trace.dt_s`` to a whole number of fine bins;
    ``k == 1`` returns the trace unchanged.
    """
    k_f = trace.dt_s / float(dt_s)
    k = int(round(k_f))
    if k < 1 or abs(k_f - k) > 1e-9 * max(k, 1):
        raise ValueError(f"dt_s={dt_s} does not divide the trace's bin "
                         f"width {trace.dt_s} into whole fine bins")
    if k == 1:
        return trace
    rate = np.repeat(trace.rate, k)         # requests/s: value is unchanged
    S, T = trace.arrivals.shape
    fine = np.empty((S, T * k), dtype=trace.arrivals.dtype)
    p = np.full(k, 1.0 / k)
    for s in range(S):
        rng = np.random.default_rng((seed, s))
        fine[s] = rng.multinomial(trace.arrivals[s].astype(np.int64),
                                  p).reshape(T * k)
    base = (None if trace.base_rate is None
            else np.repeat(trace.base_rate, k))
    return Trace(f"{trace.name}@{dt_s:g}s", float(dt_s), rate, fine,
                 base_rate=base)


def load_trace_csv(path, rate_col=1, dt_s: float = 60.0, *, mean_rate_per_s:
                   float = None, n_seeds: int = 8, seed: int = 0,
                   name: str = None, delimiter: str = ",") -> Trace:
    """Load a recorded rate profile from a CSV file into a ``replay_trace``.

    ``rate_col`` is a 0-based column index or a header name; a leading header
    row and ``#`` comment lines are tolerated (a header is required when
    ``rate_col`` is a name; with an index, the first row counts as the
    header only when *none* of its cells parse as numbers — a data row with
    a corrupt cell cannot masquerade as a header and is rejected instead).
    ``dt_s`` is the recording's bin width.
    Rows whose rate cell is missing, unparseable, or non-finite raise a
    ``ValueError`` naming the offending line — a silently skipped gap would
    shift every later bin in time. ``mean_rate_per_s`` (optional) rescales
    the profile so its mean matches a target rate — replaying a public
    trace's *shape* against a fleet sized in this repo's request units.
    """
    import os

    rates, header, col = [], None, None
    n_skipped = 0                   # blank / comment / header lines
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            row = line.strip()
            if not row or row.startswith("#"):
                n_skipped += 1
                continue
            cells = [c.strip() for c in row.split(delimiter)]
            if header is None:
                # resolve the rate column on the first non-comment row; with
                # an index column that row is a header only when NO cell is
                # numeric, so a data row with a corrupt label still raises
                # below instead of being swallowed as a "header"
                if isinstance(rate_col, str):
                    if rate_col not in cells:
                        raise ValueError(f"{path}: no column {rate_col!r} in "
                                         f"header {cells}")
                    header, col = cells, cells.index(rate_col)
                    n_skipped += 1
                    continue
                col = int(rate_col)

                def _numeric(c):
                    try:
                        float(c)
                        return True
                    except ValueError:
                        return False
                if cells and not any(_numeric(c) for c in cells):
                    header = cells          # label-only row: a real header
                    n_skipped += 1
                    continue
                header = []   # any numeric cell = data row; bad rate cells
                #               fall through to the named-line errors below
            if col >= len(cells):
                raise ValueError(f"{path}:{lineno}: row has {len(cells)} "
                                 f"column(s), rate column is {col}")
            try:
                r = float(cells[col])
            except ValueError:
                raise ValueError(f"{path}:{lineno}: rate cell "
                                 f"{cells[col]!r} is not a number") from None
            if not np.isfinite(r):
                raise ValueError(f"{path}:{lineno}: non-finite rate {r!r}")
            rates.append(r)
    if not rates:
        raise ValueError(f"{path}: no data rows")
    rates = np.clip(np.asarray(rates, float), 0.0, None)
    raw, rescale = None, 1.0
    if mean_rate_per_s is not None:
        mean = rates.mean()
        if mean <= 0:
            raise ValueError(f"{path}: all-zero trace cannot be rescaled "
                             f"to mean {mean_rate_per_s}")
        rescale = mean_rate_per_s / mean
        # the rescaled profile drives sampling, but shape statistics
        # (burstiness = peak/mean, ramp) must come from the recording: the
        # per-bin multiply rounds, so peak/mean on the rescaled array can
        # drift off the recording's by float ulps — enough to miss an exact
        # oracle grid cell. Keep the raw profile on the Trace.
        raw, rates = rates, rates * rescale
    stem = os.path.splitext(os.path.basename(str(path)))[0]
    # record what the loader did to the raw profile — a silently rescaled
    # trace is indistinguishable from the recording it came from
    from repro_torch.fleet import telemetry
    telemetry.event("trace_csv_loaded", path=str(path), rows=len(rates),
                    skipped_rows=n_skipped, rescale_factor=float(rescale),
                    mean_rate_per_s=float(rates.mean()))
    if rescale != 1.0 or n_skipped:
        _LOG.info("load_trace_csv %s: %d data rows (%d non-data lines "
                  "skipped), mean-rate rescale factor %.6g",
                  path, len(rates), n_skipped, rescale)
    return replay_trace(rates, dt_s, n_seeds, seed, name=name or stem,
                        base_rate=raw)


def standard_traces(mean_rate_per_s: float, duration_s: float, dt_s: float = 1.0,
                    n_seeds: int = 8, seed: int = 0) -> list:
    """The canonical evaluation set: steady, diurnal, flash crowd, ramp."""
    return [
        poisson_trace(mean_rate_per_s, duration_s, dt_s, n_seeds, seed),
        diurnal_trace(mean_rate_per_s, duration_s, dt_s,
                      period_s=duration_s, n_seeds=n_seeds, seed=seed + 1),
        flash_crowd_trace(mean_rate_per_s / 2, duration_s, dt_s,
                          burst_width_s=duration_s / 30,
                          n_seeds=n_seeds, seed=seed + 2),
        ramp_trace(mean_rate_per_s / 4, 2 * mean_rate_per_s, duration_s, dt_s,
                   n_seeds=n_seeds, seed=seed + 3),
    ]
