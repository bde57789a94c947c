"""Declarative controller-parameter spaces for the autonomous tuner.

A ``ParamSpace`` is an ordered tuple of named dimensions — continuous (linear
or log scale), integer, or categorical — with two seeded samplers:

* ``grid(levels)``   — full-factorial design (log-spaced where the dim says
  so), the exhaustive-sweep reference the racing loop is benchmarked against;
* ``sample_lhs(n)``  — Latin-hypercube design: every dim is stratified into n
  bins with one sample each, so n points cover every 1-D projection evenly —
  far better space-filling per simulation than iid sampling.

Policy families declare their own knob spaces (``Policy.param_space()``);
cross-cutting dims that belong to the *simulation* rather than the policy —
the scheduling discipline, per-pool quota mixes — live here and are routed by
the evaluator (``discipline`` to ``simulate_fleet``'s kwarg, ``quota:<pool>``
to the pool's ``max_replicas``). Spaces compose with ``+``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Dim:
    """One named search dimension. Subclasses map a uniform u in [0, 1) to a
    value (``from_unit``) and enumerate grid levels (``grid``)."""
    name: str

    def from_unit(self, u):
        raise NotImplementedError

    def to_unit(self, value) -> float:
        """Map a value back to [0, 1] — the inverse of ``from_unit`` (up to
        discretization), so warm-started sampling can perturb an incumbent
        configuration in unit space."""
        raise NotImplementedError

    def grid(self, levels: int) -> list:
        raise NotImplementedError

    @property
    def numeric(self) -> bool:
        """Whether the dim can enter a response-surface fit (log-space
        polynomials need strictly positive numeric coordinates)."""
        return False


@dataclass(frozen=True)
class Continuous(Dim):
    lo: float = 0.0
    hi: float = 1.0
    log: bool = False

    def __post_init__(self):
        if not (np.isfinite(self.lo) and np.isfinite(self.hi)
                and self.lo < self.hi):
            raise ValueError(f"dim {self.name!r}: need finite lo < hi, "
                             f"got [{self.lo}, {self.hi}]")
        if self.log and self.lo <= 0:
            raise ValueError(f"dim {self.name!r}: log scale needs lo > 0")

    def from_unit(self, u):
        if self.log:
            return float(self.lo * (self.hi / self.lo) ** u)
        return float(self.lo + u * (self.hi - self.lo))

    def to_unit(self, value) -> float:
        v = float(np.clip(value, self.lo, self.hi))
        if self.log:
            return float(np.log(v / self.lo) / np.log(self.hi / self.lo))
        return float((v - self.lo) / (self.hi - self.lo))

    def grid(self, levels: int) -> list:
        if self.log:
            return [float(v) for v in
                    np.geomspace(self.lo, self.hi, levels)]
        return [float(v) for v in np.linspace(self.lo, self.hi, levels)]

    @property
    def numeric(self) -> bool:
        return self.lo > 0      # log-space surface fits need positive coords


@dataclass(frozen=True)
class Integer(Dim):
    lo: int = 1
    hi: int = 16
    log: bool = False

    def __post_init__(self):
        if not self.lo < self.hi:
            raise ValueError(f"dim {self.name!r}: need lo < hi, "
                             f"got [{self.lo}, {self.hi}]")
        if self.log and self.lo <= 0:
            raise ValueError(f"dim {self.name!r}: log scale needs lo > 0")

    def from_unit(self, u):
        if self.log:
            v = self.lo * (self.hi / self.lo) ** u
        else:
            # map the unit interval onto equal-mass integer bins
            v = self.lo + u * (self.hi - self.lo + 1) - 0.5
        return int(np.clip(round(v), self.lo, self.hi))

    def to_unit(self, value) -> float:
        v = float(np.clip(value, self.lo, self.hi))
        if self.log:
            return float(np.log(v / self.lo) / np.log(self.hi / self.lo))
        return float((v - self.lo + 0.5) / (self.hi - self.lo + 1))

    def grid(self, levels: int) -> list:
        space = (np.geomspace if self.log else np.linspace)
        vals = np.clip(np.round(space(self.lo, self.hi, levels)),
                       self.lo, self.hi).astype(int)
        return sorted({int(v) for v in vals})

    @property
    def numeric(self) -> bool:
        return self.lo > 0


@dataclass(frozen=True)
class Categorical(Dim):
    choices: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "choices", tuple(self.choices))
        if not self.choices:
            raise ValueError(f"dim {self.name!r}: needs at least one choice")

    def from_unit(self, u):
        return self.choices[min(int(u * len(self.choices)),
                                len(self.choices) - 1)]

    def to_unit(self, value) -> float:
        # the center of the choice's own bin (unknown values: first choice)
        try:
            i = self.choices.index(value)
        except ValueError:
            i = 0
        return (i + 0.5) / len(self.choices)

    def grid(self, levels: int) -> list:
        return list(self.choices)


@dataclass(frozen=True)
class ParamSpace:
    """An ordered, immutable set of search dimensions."""
    dims: tuple

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(self.dims))
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dim names: {names}")

    @property
    def names(self) -> list:
        return [d.name for d in self.dims]

    def numeric_names(self) -> list:
        """Dims usable as response-surface coordinates."""
        return [d.name for d in self.dims if d.numeric]

    def __add__(self, other: "ParamSpace") -> "ParamSpace":
        return ParamSpace(self.dims + tuple(other.dims))

    def __len__(self) -> int:
        return len(self.dims)

    def sample_lhs(self, n: int, seed: int = 0) -> list:
        """n Latin-hypercube configs (dicts), deterministic under ``seed``."""
        if n < 1:
            raise ValueError("need n >= 1 samples")
        rng = np.random.default_rng(seed)
        configs = [dict() for _ in range(n)]
        for d in self.dims:
            # one stratified draw per bin, bins shuffled independently per dim
            u = (rng.permutation(n) + rng.uniform(size=n)) / n
            for i in range(n):
                configs[i][d.name] = d.from_unit(u[i])
        return configs

    def grid(self, levels: int = 4) -> list:
        """Full-factorial design: every combination of per-dim levels
        (integer dims dedupe collapsed levels; categoricals ignore
        ``levels``)."""
        configs = [dict()]
        for d in self.dims:
            configs = [dict(c, **{d.name: v})
                       for c in configs for v in d.grid(levels)]
        return configs

    def to_json(self) -> list:
        """JSON-serializable dim list (``OracleTable``/``TuningReport``
        artifacts carry their search space so a loaded table can interpolate
        winners in each dim's own unit coordinates)."""
        return [dim_to_json(d) for d in self.dims]

    @staticmethod
    def from_json(dims: list) -> "ParamSpace":
        return ParamSpace(tuple(dim_from_json(d) for d in dims))


def dim_to_json(dim: Dim) -> dict:
    """One dim as a plain JSON object (inverse: ``dim_from_json``)."""
    if isinstance(dim, Continuous):
        return {"kind": "continuous", "name": dim.name, "lo": dim.lo,
                "hi": dim.hi, "log": dim.log}
    if isinstance(dim, Integer):
        return {"kind": "integer", "name": dim.name, "lo": dim.lo,
                "hi": dim.hi, "log": dim.log}
    if isinstance(dim, Categorical):
        return {"kind": "categorical", "name": dim.name,
                "choices": list(dim.choices)}
    raise TypeError(f"cannot serialize dim type {type(dim).__name__}")


def dim_from_json(d: dict) -> Dim:
    kind = d.get("kind")
    if kind == "continuous":
        return Continuous(d["name"], float(d["lo"]), float(d["hi"]),
                          bool(d.get("log", False)))
    if kind == "integer":
        return Integer(d["name"], int(d["lo"]), int(d["hi"]),
                       bool(d.get("log", False)))
    if kind == "categorical":
        return Categorical(d["name"], tuple(d["choices"]))
    raise ValueError(f"unknown dim kind {kind!r}")


# ---- cross-cutting dims (simulation-level, routed by the evaluator) --------

def discipline_dim(choices=("fifo", "priority", "edf")) -> Categorical:
    """Scheduling discipline as a tunable categorical — the tuner can search
    it jointly with the policy knobs."""
    return Categorical("discipline", tuple(choices))


def quota_dims(fleet, lo: int = 1, hi: int = None) -> ParamSpace:
    """Per-pool quota mix: one ``quota:<pool-label>`` integer dim per pool of
    ``fleet``, never exceeding the pool's own ``max_replicas`` (that is the
    cloud's quota — a tuned config above it would be undeployable); ``hi``
    may tighten it further. Pools whose quota leaves no room to search
    (``max_replicas <= lo``) get no dim and keep their configured bound."""
    dims = []
    for p in fleet.pools:
        top = int(min(p.max_replicas, p.max_replicas if hi is None else hi))
        if top <= lo:
            continue
        dims.append(Integer(f"quota:{p.label}", lo, top,
                            log=lo > 0 and top - lo > 8))
    return ParamSpace(tuple(dims))
