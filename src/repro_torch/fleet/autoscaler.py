"""Pluggable autoscaling policies.

All policies are vectorized over Monte Carlo seeds: ``decide`` receives
(n_seeds,) observation vectors and returns an (n_seeds,) replica target.

* ``StaticPolicy``           — fixed fleet (the paper's one-shot scoping answer).
* ``ReactivePolicy``         — ServerlessContainers-style utilization rules:
  scale up above an upper bound, down below a lower bound, with a per-seed
  cooldown; pays the cold start on every burst.
* ``QueueProportionalPolicy``— targets enough replicas to absorb the current
  arrival rate plus drain the backlog within ``drain_s``.
* ``PredictivePolicy``       — forecasts the arrival rate one cold-start horizon
  ahead and provisions for it; its *shape* is pre-picked by the scoping stack
  (``recommend()`` over CellResult rows) and its capacity estimate comes from a
  ``ResponseSurface`` fitted on the service batch time over the batch grid.
* ``PIPolicy`` / ``PIDPolicy`` — classical feedback in the style of
  ServerlessContainers' ``PIController``: the replica target is a base count
  plus a PI(D) correction on the error between an observed signal
  (utilization or normalized queue depth) and its setpoint, with an
  anti-windup clamp on the integral term. Zero gains degenerate exactly to
  ``StaticPolicy``.
* ``FitToUsagePolicy``       — ServerlessContainers ``Guardian``-style
  fit-to-usage rule: capacity follows the rolling peak of *observed used*
  capacity plus a headroom margin, never demand forecasts.

Each built-in family also has a *functional kernel* — the pure
``init/step``-over-arrays decomposition the compiled simulator backend scans
and batches (``repro_torch.fleet.kernels``). ``Policy.kernel()`` resolves it;
custom subclasses may override it to ride the compiled path, or leave it
returning ``None`` to stay on the numpy reference loop.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.recommender import Constraint, feasible_ranking, recommend
from repro_torch.core.surfaces import fit_response_surface
from repro_torch.fleet.workload import ServiceModel, service_model_from_cell

_EPS = 1e-12


class Policy:
    """Base: stateless sizing against the bound service's capacity.

    ``per_pool = True`` marks policies whose ``decide`` returns an
    (n_seeds, n_pools) per-pool target for heterogeneous fleets; plain
    policies return (n_seeds,) and only drive single-pool fleets.

    Every policy family also declares its tunable knobs: ``param_space()``
    returns the ``repro_torch.fleet.tuning.ParamSpace`` the autonomous tuner
    searches, and ``from_params(params, **context)`` instantiates the policy
    from one sampled point. ``context`` carries whatever the constructor
    needs beyond the tuned knobs (scoping rows, constraint, fleet...)."""
    name = "policy"
    per_pool = False
    service: ServiceModel = None     # optional shape override (predictive)

    def reset(self, n_seeds: int) -> None:
        pass

    def decide(self, t: int, obs) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def param_space(cls):
        """The tunable-knob space of this policy family (dims must match the
        keys ``from_params`` consumes)."""
        raise NotImplementedError(f"{cls.__name__} declares no param space")

    @classmethod
    def from_params(cls, params: dict, **context):
        """Build an instance from one sampled ``param_space()`` point."""
        raise NotImplementedError(f"{cls.__name__} declares no param space")

    def kernel(self, fleet, classes, **kw):
        """The functional form of this policy's family for the compiled
        simulator backend (``repro_torch.fleet.kernels.PolicyKernel``), or ``None``
        when the family has none (the numpy reference path then runs the
        object policy as-is). ``self`` doubles as the reference instance for
        family structure that is not a tunable knob (capacity rate,
        base/burst pool split). Subclasses with their own pure
        ``init/step`` decomposition may override this; returning the SAME
        kernel object for equal configs keeps the backend's cold/warm
        dispatch classification stable and lets candidate slates batch."""
        from repro_torch.fleet.kernels import make_kernel
        return make_kernel(self, fleet, classes, **kw)


class _RateForecaster:
    """Shared linear-trend forecaster over a rolling arrival-rate window."""

    def __init__(self, window_bins: int, horizon_s: float):
        self.window_bins = max(int(window_bins), 2)
        self.horizon_s = horizon_s
        self._hist = None
        self._n_obs = 0

    def reset(self, n_seeds: int) -> None:
        self._hist = np.zeros((self.window_bins, n_seeds))
        self._n_obs = 0

    def observe(self, obs) -> np.ndarray:
        """Record this bin's arrival rate; return the rate forecast one
        horizon ahead (per seed)."""
        self._hist = np.roll(self._hist, -1, axis=0)
        self._hist[-1] = obs.arrival_rate
        self._n_obs += 1
        w = min(self._n_obs, self.window_bins)
        H = self._hist[-w:]
        if w >= 3:
            x = np.arange(w) - (w - 1) / 2.0
            slope = (x[:, None] * (H - H.mean(axis=0))).sum(axis=0) / (x ** 2).sum()
            return H[-1] + slope * (self.horizon_s / obs.dt_s)
        return H[-1]

    def mean_rate(self) -> np.ndarray:
        """Rolling-mean arrival rate over the observed window (the sustained
        component of demand)."""
        w = min(max(self._n_obs, 1), self.window_bins)
        return self._hist[-w:].mean(axis=0)


def _replicas_for_rate(rate: np.ndarray, service: ServiceModel,
                       headroom: float) -> np.ndarray:
    """Replicas needed to serve ``rate`` req/s at <= ``headroom`` utilization."""
    per = max(service.max_throughput * headroom, _EPS)
    return np.ceil(np.maximum(rate, 0.0) / per)


def _queue_demand(obs, drain_s: float) -> np.ndarray:
    """Backlog-drain demand in req/s. With multiple request classes each
    class's backlog must clear within its own SLO (a 30 s batch backlog is not
    the emergency a 1 s interactive backlog is), so per-class backlog is
    divided by min(drain_s, slo). Single-class observations keep the original
    aggregate rule exactly."""
    if getattr(obs, "class_queue", None) is None or len(obs.classes) <= 1:
        return obs.queue / max(drain_s, obs.dt_s)
    slos = np.array([c.slo_s for c in obs.classes])
    horizon = np.maximum(np.minimum(drain_s, slos), obs.dt_s)
    return (obs.class_queue / horizon[None, :]).sum(axis=1)


class StaticPolicy(Policy):
    name = "static"

    def __init__(self, n_replicas: int):
        self.n = int(n_replicas)

    def decide(self, t, obs):
        return np.full_like(obs.replicas, self.n)

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Integer, ParamSpace
        return ParamSpace((Integer("n_replicas", 1, 64, log=True),))

    @classmethod
    def from_params(cls, params, **context):
        return cls(int(params["n_replicas"]))


class ReactivePolicy(Policy):
    name = "reactive"

    def __init__(self, upper: float = 0.8, lower: float = 0.3,
                 scale_up_frac: float = 0.5, scale_down_frac: float = 0.25,
                 cooldown_s: float = 60.0):
        assert 0.0 <= lower < upper <= 1.0
        self.upper, self.lower = upper, lower
        self.up_frac, self.down_frac = scale_up_frac, scale_down_frac
        self.cooldown_s = cooldown_s
        self._last = None

    def reset(self, n_seeds):
        self._last = np.full(n_seeds, -np.inf)

    def decide(self, t, obs):
        total = obs.replicas + obs.in_flight
        target = total.copy()
        actionable = obs.t_s - self._last >= self.cooldown_s
        # a fleet scaled to zero pins utilization at 0 and the upper-bound rule
        # alone would never fire again — starvation overrides the cooldown
        starved = (total < 1) & ((obs.queue >= 1) | (obs.arrival_rate > 0))
        up = (actionable & (obs.utilization >= self.upper)) | starved
        down = actionable & ~starved & (obs.utilization <= self.lower) \
            & (obs.queue < 1)
        target[up] = np.maximum(
            total[up] + np.maximum(np.ceil(total[up] * self.up_frac), 1), 1)
        target[down] = total[down] - np.maximum(
            np.ceil(total[down] * self.down_frac), 1)
        self._last[up | down] = obs.t_s
        return target

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Continuous, ParamSpace
        # lower is parameterized as a fraction of upper so every sampled
        # point satisfies the constructor's 0 <= lower < upper <= 1
        return ParamSpace((
            Continuous("upper", 0.55, 0.95),
            Continuous("lower_frac", 0.1, 0.8),
            Continuous("scale_up_frac", 0.2, 1.0),
            Continuous("scale_down_frac", 0.1, 0.6),
            Continuous("cooldown_s", 10.0, 600.0, log=True),
        ))

    @classmethod
    def from_params(cls, params, **context):
        upper = float(params["upper"])
        return cls(upper=upper,
                   lower=float(params["lower_frac"]) * upper,
                   scale_up_frac=float(params["scale_up_frac"]),
                   scale_down_frac=float(params["scale_down_frac"]),
                   cooldown_s=float(params["cooldown_s"]))


class QueueProportionalPolicy(Policy):
    name = "queue-prop"

    def __init__(self, drain_s: float = 30.0, headroom: float = 0.85):
        self.drain_s = drain_s
        self.headroom = headroom

    def decide(self, t, obs):
        demand = obs.arrival_rate + _queue_demand(obs, self.drain_s)
        return _replicas_for_rate(demand, obs.service, self.headroom)

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Continuous, ParamSpace
        return ParamSpace((
            Continuous("drain_s", 5.0, 120.0, log=True),
            Continuous("headroom", 0.55, 0.98),
        ))

    @classmethod
    def from_params(cls, params, **context):
        return cls(drain_s=float(params["drain_s"]),
                   headroom=float(params["headroom"]))


class PredictivePolicy(Policy):
    """Scoping-stack-driven: shape from ``recommend()``, capacity from a
    ``ResponseSurface`` over the service batch time, replicas from a linear
    forecast one cold-start horizon ahead."""
    name = "predictive"

    def __init__(self, rows, constraint: Constraint, units_per_step: float,
                 horizon_s: float = 60.0, window_bins: int = 12,
                 headroom: float = 0.85, max_batch: int = None):
        ref = [r for r in rows
               if float(r.params.get("batch", units_per_step)) == units_per_step]
        self.recommendation = recommend(ref, constraint)
        if self.recommendation.shape is None:
            raise ValueError("predictive policy: no feasible shape "
                             f"({self.recommendation.reason})")
        shape_name = self.recommendation.shape.name
        cell = next(r for r in ref if r.shape_name == shape_name)
        self.service = service_model_from_cell(cell, units_per_step,
                                               max_batch=max_batch)
        # Provisioning capacity from a response surface over the batch
        # dimension, fitted on the same fixed+linear service decomposition the
        # simulator bills (``CellResult.service_terms``): exact on the scoped
        # batch grid, interpolating anywhere else.
        mine = [r for r in rows if r.shape_name == shape_name
                and "batch" in r.params]
        self.surface = None
        if len({float(r.params["batch"]) for r in mine}) >= 3:
            X = np.array([[float(r.params["batch"])] for r in mine])
            y = np.array([sum(r.service_terms(1.0)) for r in mine])
            self.surface = fit_response_surface(["batch"], X, y, degree=2)
            mb = float(self.service.max_batch)
            self._rate = mb / max(self.surface.predict({"batch": mb}), _EPS)
        else:
            self._rate = self.service.max_throughput
        self.horizon_s = horizon_s
        self.forecaster = _RateForecaster(window_bins, horizon_s)
        self.headroom = headroom

    def reset(self, n_seeds):
        self.forecaster.reset(n_seeds)

    def decide(self, t, obs):
        forecast = self.forecaster.observe(obs)
        demand = np.maximum(forecast, obs.arrival_rate) \
            + _queue_demand(obs, self.horizon_s)
        per = max(self._rate * self.headroom, _EPS)
        return np.ceil(np.maximum(demand, 0.0) / per)

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Continuous, Integer, ParamSpace
        return ParamSpace((
            Continuous("horizon_s", 10.0, 600.0, log=True),
            Integer("window_bins", 3, 48, log=True),
            Continuous("headroom", 0.55, 0.98),
        ))

    @classmethod
    def from_params(cls, params, *, rows, constraint, units_per_step,
                    max_batch=None, **context):
        return cls(rows, constraint, units_per_step,
                   horizon_s=float(params["horizon_s"]),
                   window_bins=int(params["window_bins"]),
                   headroom=float(params["headroom"]),
                   max_batch=max_batch)


class HeterogeneousPredictivePolicy(Policy):
    """Per-pool predictive autoscaling for mixed-shape fleets.

    ``recommend()``'s feasibility ranking splits the fleet's pools into a
    *baseline* pool (the cheapest feasible shape — head of the ranking) and
    *burst* pools (the rest, in ranking order). The baseline pool tracks the
    sustained arrival rate (rolling mean), so it only moves slowly; the burst
    pools absorb the forecast excess — coarse-grained capacity that spins up
    ahead of a flash crowd and cancels back down after it. Demand the burst
    pools cannot hold (their quota ``max_replicas``) falls back to baseline.

    With a multi-class workload, capacity is split by class criticality: a
    class whose SLO is tighter than the burst pools' cold start cannot wait
    for burst capacity to spin up, so its arrival rate and backlog-drain
    demand floor the always-ready baseline pool instead of riding the
    forecast into the burst pools.
    """
    name = "hetero-predictive"
    per_pool = True

    def __init__(self, rows, constraint: Constraint, units_per_step: float,
                 fleet, horizon_s: float = 60.0, window_bins: int = 12,
                 sustain_bins: int = 60, headroom: float = 0.85):
        self.fleet = fleet
        pool_shapes = {p.service.shape.name for p in fleet.pools}
        ref = [r for r in rows
               if float(r.params.get("batch", units_per_step)) == units_per_step
               and r.shape_name in pool_shapes]
        self.recommendation = recommend(ref, constraint)
        if self.recommendation.shape is None:
            raise ValueError("hetero-predictive policy: no feasible pool shape "
                             f"({self.recommendation.reason})")
        rank = [s.name for _, _, s in feasible_ranking(ref, constraint)]
        pos = {name: i for i, name in enumerate(rank)}
        by_rank = sorted(range(len(fleet.pools)),
                         key=lambda i: (pos.get(
                             fleet.pools[i].service.shape.name, len(rank)), i))
        self.base_idx = by_rank[0]
        self.burst_idx = by_rank[1:]
        self.horizon_s = horizon_s
        self.headroom = headroom
        self.forecaster = _RateForecaster(window_bins, horizon_s)
        self.sustain = _RateForecaster(max(int(sustain_bins), 2), horizon_s)

    def reset(self, n_seeds):
        self.forecaster.reset(n_seeds)
        self.sustain.reset(n_seeds)

    def _per_replica(self, pool) -> float:
        return max(pool.service.max_throughput * self.headroom, _EPS)

    def _critical_demand(self, obs) -> np.ndarray:
        """Demand (req/s) from classes too latency-critical for burst pools:
        their SLO is shorter than the burst cold start, so a backlog would
        miss its deadline before burst capacity comes up."""
        lag = max(self.fleet.pools[i].cold_start_mean_s
                  for i in self.burst_idx)
        crit = np.array([c.slo_s <= lag for c in obs.classes])
        if not crit.any():
            return np.zeros_like(obs.queue)
        slos = np.array([c.slo_s for c in obs.classes])
        horizon = np.maximum(np.minimum(self.horizon_s, slos), obs.dt_s)
        return (obs.class_arrival_rate[:, crit].sum(axis=1)
                + (obs.class_queue[:, crit] / horizon[crit][None, :])
                .sum(axis=1))

    def decide(self, t, obs):
        forecast = self.forecaster.observe(obs)
        self.sustain.observe(obs)
        demand = np.maximum(forecast, obs.arrival_rate) \
            + _queue_demand(obs, self.horizon_s)
        demand = np.maximum(demand, 0.0)
        pools = self.fleet.pools
        target = np.zeros((len(obs.queue), len(pools)))

        base_pool = pools[self.base_idx]
        base_cap = self._per_replica(base_pool)
        base_demand = self.sustain.mean_rate()
        if len(getattr(obs, "classes", ())) > 1 and self.burst_idx:
            base_demand = np.maximum(base_demand, self._critical_demand(obs))
        base = np.clip(np.ceil(base_demand / base_cap),
                       base_pool.min_replicas, base_pool.max_replicas)
        residual = np.maximum(demand - base * base_cap, 0.0)
        for i in self.burst_idx:
            cap = self._per_replica(pools[i])
            n = np.clip(np.ceil(residual / cap),
                        pools[i].min_replicas, pools[i].max_replicas)
            target[:, i] = n
            residual = np.maximum(residual - n * cap, 0.0)
        # overflow beyond every burst quota lands back on the baseline pool
        target[:, self.base_idx] = np.clip(base + np.ceil(residual / base_cap),
                                           base_pool.min_replicas,
                                           base_pool.max_replicas)
        return target

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Continuous, Integer, ParamSpace
        return ParamSpace((
            Continuous("horizon_s", 10.0, 600.0, log=True),
            Integer("window_bins", 3, 48, log=True),
            Integer("sustain_bins", 12, 240, log=True),
            Continuous("headroom", 0.55, 0.98),
        ))

    @classmethod
    def from_params(cls, params, *, rows, constraint, units_per_step, fleet,
                    **context):
        return cls(rows, constraint, units_per_step, fleet,
                   horizon_s=float(params["horizon_s"]),
                   window_bins=int(params["window_bins"]),
                   sustain_bins=int(params["sustain_bins"]),
                   headroom=float(params["headroom"]))


class PIPolicy(Policy):
    """Proportional-integral feedback on a utilization or queue setpoint.

    The replica target is ``n_base + round(kp * e + ki * I)`` where the
    error ``e`` is the observed signal minus its setpoint and ``I`` is the
    running error integral, clamped to ``[-windup, +windup]`` (anti-windup:
    a long saturated excursion cannot bank unbounded authority, so the
    controller's reach is bounded by ``n_base + kp * e + ki * windup`` —
    re-centering ``n_base`` is the re-tuner's job when the world shifts).

    ``signal="utilization"`` drives on ``utilization - setpoint``;
    ``signal="queue"`` drives on backlog normalized to the base capacity
    per bin (``queue / (n_base * max_throughput * dt)``), which keeps
    growing past saturation where utilization pins at 1. With
    ``kp == ki == 0`` the policy is exactly ``StaticPolicy(n_base)``.

    A starvation guard holds at least one replica while work is queued or
    arriving: at zero replicas the utilization signal is dead (nothing
    serves, so utilization reads 0), the error pins negative, and the
    integrator locks the fleet at zero forever — the guard is the one
    non-feedback escape from that death spiral."""
    name = "pi"

    def __init__(self, n_base: int, kp: float = 8.0, ki: float = 1.0,
                 setpoint: float = 0.7, signal: str = "utilization",
                 windup: float = 16.0):
        if signal not in ("utilization", "queue"):
            raise ValueError(f"signal must be 'utilization' or 'queue', "
                             f"got {signal!r}")
        if not (np.isfinite(windup) and windup >= 0):
            raise ValueError(f"windup must be >= 0, got {windup}")
        self.n_base = int(n_base)
        self.kp = float(kp)
        self.ki = float(ki)
        self.setpoint = float(setpoint)
        self.signal = signal
        self.windup = float(windup)
        self._i = None

    def reset(self, n_seeds):
        self._i = np.zeros(n_seeds)

    def _error(self, obs) -> np.ndarray:
        if self.signal == "queue":
            cap = max(self.n_base * obs.service.max_throughput * obs.dt_s,
                      _EPS)
            v = obs.queue / cap
        else:
            v = obs.utilization
        return v - self.setpoint

    def _floor(self, target, obs):
        starved = (obs.queue >= 1.0) | (obs.arrival_rate > 0.0)
        return np.maximum(target, np.where(starved, 1.0, 0.0))

    def decide(self, t, obs):
        e = self._error(obs)
        self._i = np.clip(self._i + e, -self.windup, self.windup)
        target = np.maximum(
            np.rint(self.n_base + self.kp * e + self.ki * self._i), 0.0)
        return self._floor(target, obs)

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Continuous, Integer, ParamSpace
        return ParamSpace((
            Integer("n_base", 1, 48, log=True),
            Continuous("kp", 0.25, 32.0, log=True),
            Continuous("ki", 0.02, 8.0, log=True),
            Continuous("setpoint", 0.35, 0.9),
            Continuous("windup", 2.0, 64.0, log=True),
        ))

    @classmethod
    def from_params(cls, params, *, signal: str = "utilization", **context):
        return cls(n_base=int(params["n_base"]), kp=float(params["kp"]),
                   ki=float(params["ki"]),
                   setpoint=float(params["setpoint"]), signal=signal,
                   windup=float(params["windup"]))


class PIDPolicy(PIPolicy):
    """``PIPolicy`` plus a derivative term ``kd * (e_t - e_{t-1})`` (the
    previous error starts at 0): the kick damps overshoot on sharp error
    swings. ``kd == 0`` decides identically to ``PIPolicy``."""
    name = "pid"

    def __init__(self, n_base: int, kp: float = 8.0, ki: float = 1.0,
                 kd: float = 0.0, setpoint: float = 0.7,
                 signal: str = "utilization", windup: float = 16.0):
        super().__init__(n_base, kp=kp, ki=ki, setpoint=setpoint,
                         signal=signal, windup=windup)
        self.kd = float(kd)
        self._prev = None

    def reset(self, n_seeds):
        super().reset(n_seeds)
        self._prev = np.zeros(n_seeds)

    def decide(self, t, obs):
        e = self._error(obs)
        self._i = np.clip(self._i + e, -self.windup, self.windup)
        d = e - self._prev
        self._prev = e
        target = np.maximum(
            np.rint(self.n_base + self.kp * e + self.ki * self._i
                    + self.kd * d), 0.0)
        return self._floor(target, obs)

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Continuous, ParamSpace
        return PIPolicy.param_space() + ParamSpace((
            Continuous("kd", 0.02, 16.0, log=True),))

    @classmethod
    def from_params(cls, params, *, signal: str = "utilization", **context):
        return cls(n_base=int(params["n_base"]), kp=float(params["kp"]),
                   ki=float(params["ki"]), kd=float(params["kd"]),
                   setpoint=float(params["setpoint"]), signal=signal,
                   windup=float(params["windup"]))


class FitToUsagePolicy(Policy):
    """ServerlessContainers ``Guardian``-style fit-to-usage rule: capacity
    follows *observed usage*, not demand estimates. Each bin records the
    used capacity (``utilization * ready replicas``, in replica
    equivalents); the target is the rolling peak over the last
    ``window_bins`` bins plus a multiplicative ``headroom`` margin. A
    saturated fleet (utilization pinned at 1) therefore grows
    geometrically by ``1 + headroom`` per window until headroom reappears,
    and an idle fleet decays once the peak ages out — with a starvation
    guard holding at least one replica while there is any demand."""
    name = "fit-to-usage"

    def __init__(self, headroom: float = 0.3, window_bins: int = 6):
        if not (np.isfinite(headroom) and headroom >= 0):
            raise ValueError(f"headroom must be >= 0, got {headroom}")
        self.headroom = float(headroom)
        self.window_bins = max(int(window_bins), 1)
        self._hist = None
        self._n_obs = 0

    def reset(self, n_seeds):
        self._hist = np.zeros((self.window_bins, n_seeds))
        self._n_obs = 0

    def decide(self, t, obs):
        used = obs.utilization * np.maximum(obs.replicas, 0.0)
        self._hist = np.roll(self._hist, -1, axis=0)
        self._hist[-1] = used
        self._n_obs += 1
        w = min(self._n_obs, self.window_bins)
        fit = self._hist[-w:].max(axis=0)
        target = np.ceil(fit * (1.0 + self.headroom))
        starved = (obs.queue >= 1) | (obs.arrival_rate > 0)
        return np.maximum(target, np.where(starved, 1.0, 0.0))

    @classmethod
    def param_space(cls):
        from repro_torch.fleet.tuning.space import Continuous, Integer, ParamSpace
        return ParamSpace((
            Continuous("headroom", 0.05, 1.5, log=True),
            Integer("window_bins", 2, 24, log=True),
        ))

    @classmethod
    def from_params(cls, params, **context):
        return cls(headroom=float(params["headroom"]),
                   window_bins=int(params["window_bins"]))


def default_policies(rows, constraint: Constraint, units_per_step: float,
                     static_replicas: int, cold_start_s: float = 30.0) -> list:
    """The four canonical policies, comparably configured."""
    return [
        StaticPolicy(static_replicas),
        ReactivePolicy(cooldown_s=2 * cold_start_s),
        QueueProportionalPolicy(),
        PredictivePolicy(rows, constraint, units_per_step,
                         horizon_s=2 * cold_start_s),
    ]
