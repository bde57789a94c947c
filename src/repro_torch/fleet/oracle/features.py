"""Trace featurization: the coordinates a scoping query is answered in.

The oracle precomputes tuner answers over a grid of workload *regimes*, not
individual traces — so a live trace must map onto a small feature vector that
(a) is **invariant under seed resampling**: features read only the expected
rate profile, never the Poisson arrival draws, so two Monte Carlo samplings
of the same profile featurize identically; and (b) is **equivariant under
rate rescale**: scaling a profile by ``c`` multiplies ``mean_rate`` by ``c``
and leaves every shape statistic (burstiness, ramp, class mix) unchanged —
a recorded trace replayed at a different traffic volume lands on the same
grid column, shifted only along the rate axis. Shape statistics come from
``Trace.shape_profile`` (the pre-rescale recording when the loader rescaled),
so a ``load_trace_csv(..., mean_rate_per_s=...)`` replay is *bit-identical*
in shape to its recording, not merely close.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.fleet.traces import Trace
from repro_torch.fleet.workload import Workload


@dataclass(frozen=True)
class TraceFeatures:
    """The oracle's query coordinates for one workload.

    * ``mean_rate``  — expected requests/s averaged over the trace (the only
      feature that scales with traffic volume);
    * ``burstiness`` — peak/mean of the rate profile (1.0 = steady);
    * ``ramp``       — sharpest one-bin fractional rate increase,
      ``max(diff(profile)) / mean(profile)`` (0 for non-increasing profiles;
      per *bin*, so it is invariant under ``resample_trace``'s bin
      subdivision as well as under rescale);
    * ``class_mix``  — per-class share of expected traffic, in workload
      class order, summing to 1 (``(1.0,)`` for a bare trace).
    """
    mean_rate: float
    burstiness: float
    ramp: float
    class_mix: tuple = (1.0,)

    def scaled(self, rate_factor: float) -> "TraceFeatures":
        """The same regime at ``rate_factor`` x the traffic — how the
        closed loop inflates a query by its estimated degradation factor
        (a node serving f-times slower looks, for capacity purposes, like
        f-times the traffic on healthy nodes)."""
        if rate_factor <= 0:
            raise ValueError(f"rate_factor must be > 0, got {rate_factor}")
        return TraceFeatures(self.mean_rate * float(rate_factor),
                             self.burstiness, self.ramp, self.class_mix)

    def as_dict(self) -> dict:
        return {"mean_rate": self.mean_rate, "burstiness": self.burstiness,
                "ramp": self.ramp, "class_mix": list(self.class_mix)}

    @staticmethod
    def from_dict(d: dict) -> "TraceFeatures":
        return TraceFeatures(float(d["mean_rate"]), float(d["burstiness"]),
                             float(d["ramp"]),
                             tuple(float(v) for v in d.get("class_mix",
                                                           (1.0,))))


def _profile_stats(profile: np.ndarray) -> tuple:
    """(burstiness, ramp) of a rate profile; scale-invariant by construction
    (both are ratios against the profile's own mean)."""
    p = np.asarray(profile, float)
    mean = p.mean()
    if not np.isfinite(mean) or mean <= 0:
        raise ValueError("cannot featurize an all-zero or non-finite "
                         "rate profile")
    burst = float(p.max() / mean)
    ramp = float(max(np.diff(p).max(initial=0.0), 0.0) / mean)
    return burst, ramp


def featurize(workload) -> TraceFeatures:
    """Featurize a :class:`Trace` or :class:`Workload`.

    Only the deterministic rate profile is read — never the sampled
    arrivals — so featurization is exactly invariant under re-seeding the
    Monte Carlo draws. For a bare trace, shape statistics use
    ``shape_profile`` (the pre-rescale recording when one exists) while
    ``mean_rate`` uses the actual (possibly rescaled) intensity. A
    multi-class workload aggregates per-class rates and adds the class mix.
    """
    if isinstance(workload, Trace):
        tr = workload
        mean_rate = float(np.asarray(tr.rate, float).mean())
        if not np.isfinite(mean_rate) or mean_rate <= 0:
            raise ValueError(f"trace {tr.name!r}: cannot featurize an "
                             "all-zero or non-finite rate profile")
        burst, ramp = _profile_stats(tr.shape_profile)
        return TraceFeatures(mean_rate, burst, ramp, (1.0,))
    if isinstance(workload, Workload):
        rates = [np.asarray(tr.rate, float) for tr in workload.traces]
        total = np.sum(rates, axis=0)
        mean_rate = float(total.mean())
        if not np.isfinite(mean_rate) or mean_rate <= 0:
            raise ValueError(f"workload {workload.name!r}: cannot featurize "
                             "an all-zero or non-finite rate profile")
        burst, ramp = _profile_stats(total)
        mix = tuple(float(r.mean()) / mean_rate for r in rates)
        return TraceFeatures(mean_rate, burst, ramp, mix)
    raise TypeError(f"featurize expects a Trace or Workload, got "
                    f"{type(workload).__name__}")
