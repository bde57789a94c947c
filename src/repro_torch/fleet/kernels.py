"""Functional policy kernels: the compiled-backend counterpart of
``repro_torch.fleet.autoscaler``'s object policies, in torch.

The counterpart of ``repro/fleet/kernels.py``. An object policy is a stateful
Python callable (``reset``/``decide``), which suits the numpy simulator; the
batched bin loop of ``repro_torch.fleet.torchsim`` needs the policy as pure
functions over tensors instead. A ``PolicyKernel`` is that decomposition for one
policy *family*:

* ``params_of(policy)`` -- the tunable knobs of one configured instance as a flat
  dict of scalars. Stacked over candidates they become (N, 1) tensors.
* ``init(n, s, device)`` -- the controller state (forecaster ring buffers,
  cooldown clocks) for n candidates x s seeds.
* ``step(params, state, obs) -> (state, target)`` -- one control decision for
  the whole (N, S) batch; ``obs`` is a :class:`KernelObs`, ``target`` the
  (N, S, n_pools) replica ask before quota clipping.

Every tensor carries explicit leading (N candidates, S seeds) dims, where the
reference vmaps. Ring buffers are (W, N, S): the window is the outer dim, so a
window sum is a cumulative sum along an outer dim (:func:`seq_sum0`), which adds
left to right like numpy's sum over axis 0 of an (n_bins, n_seeds) array. With
one seed numpy's window is one contiguous column, which it sums pairwise; the
kernels then reproduce that order (:func:`_window_sum`).

Anything a family needs beyond its knobs (service throughputs, the
recommend()-derived capacity rate, the base/burst pool split, class SLOs) is
baked into the kernel's closures as Python floats at build time: it is scenario
structure, identical across the candidates of a round, and a Python float costs
no host-to-device copy in the bin loop.

Float64 results must match the numpy policies to the last bit, since one ulp on a
forecast can flip a ``ceil()`` and move a replica count. So the step functions
use no fused op (``addcmul``, ``lerp``), sum short dims with explicit adds in
numpy's order, and never divide a tensor by a Python number: PyTorch's CUDA
division turns a host-scalar divisor into a multiply by its reciprocal, which is
not the IEEE quotient (:func:`div`).

Ring-buffer sizes are static: a kernel built with ``max_window=W`` masks down to
each candidate's own ``window_bins <= W``. Policies with no kernel (custom
Python subclasses) return ``None`` from :func:`make_kernel` and keep running on
the numpy reference path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.fleet import telemetry
from repro_torch.fleet.autoscaler import (
    FitToUsagePolicy,
    HeterogeneousPredictivePolicy,
    PIDPolicy,
    PIPolicy,
    PredictivePolicy,
    QueueProportionalPolicy,
    ReactivePolicy,
    StaticPolicy,
)

_EPS = 1e-12


class KernelObs(NamedTuple):
    """The observation handed to ``PolicyKernel.step`` for the whole batch --
    the tensor mirror of :class:`repro_torch.fleet.simulator.FleetObs`. Shapes
    are (N, S) unless noted; ``t_s`` and ``dt_s`` are Python floats."""

    t_s: float  # sim time at bin end
    dt_s: float
    arrival_rate: torch.Tensor  # requests/s this bin, all classes
    queue: torch.Tensor  # backlog after serving/drops, all classes
    replicas: torch.Tensor  # ready replicas this bin, all pools
    in_flight: torch.Tensor  # replicas still cold-starting, all pools
    utilization: torch.Tensor  # served / capacity, in [0, 1]
    pool_replicas: torch.Tensor  # (N, S, n_pools) ready per pool
    pool_in_flight: torch.Tensor  # (N, S, n_pools) cold-starting per pool
    class_queue: torch.Tensor  # (N, S, n_classes) backlog per class
    class_arrival_rate: torch.Tensor  # (N, S, n_classes) req/s per class
    min_replicas: torch.Tensor  # (N, 1, n_pools) candidate quota floor
    max_replicas: torch.Tensor  # (N, 1, n_pools) candidate quota ceiling


@dataclass(frozen=True)
class PolicyKernel:
    """One policy family as pure functions (see module docstring)."""

    name: str
    param_names: tuple
    params_of: Callable  # Policy instance -> {name: float}
    init: Callable  # (n, s, device) -> state
    step: Callable  # (params, state, obs) -> (state, (N, S, P) target)


def div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` rounded as IEEE division. A Python-number divisor is made a
    0-dim tensor on ``a``'s device first: CUDA divides by a host scalar as a
    multiply by its reciprocal, which can differ from the quotient by an ulp."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), float(b), dtype=a.dtype, device=a.device)
    return a / b


def add_all(parts) -> torch.Tensor:
    """``((p0 + p1) + p2) ...``: numpy's order for a row of fewer than 8
    contiguous elements (classes, pools)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def seq_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over a short last dim (classes, pools) in numpy's order."""
    return add_all([x[..., i] for i in range(x.shape[-1])])


def seq_sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 left to right, as numpy sums axis 0 of a 2-D array with
    more than one column (numpy sums a single contiguous column pairwise).

    A cumulative sum along an outer dim runs one sequential loop per column, on
    the CPU and in CUDA's outer-dim scan; ``chip_smoke.py`` checks it bit for
    bit on the card. A tensor that is all dim 0 would take CUDA's parallel 1-D
    scan instead, so it gets a second column first."""
    rest = x.shape[1:]
    if x.numel() == x.shape[0]:
        x = x.reshape(-1, 1).expand(-1, 2)
        return torch.cumsum(x, 0)[-1, 0].reshape(rest)
    return torch.cumsum(x, 0)[-1]


def _pairwise_block(x, pos, start, n):
    """numpy's ``pairwise_sum`` of ``n <= 128`` elements of ``x`` along dim 0 from
    ring position ``start``: eight lane accumulators over the first ``n - n % 8``
    elements (none when ``n < 8``), combined as a tree, then the rest added in
    order. ``pos`` is each slot's ring position; ``start`` and ``n`` are tensors."""
    j = (pos - start)[..., None]
    m = torch.where(n >= 8, n - torch.fmod(n, 8.0), 0.0)
    lane = torch.arange(8, dtype=x.dtype, device=x.device)
    sel = (j >= 0) & (j < m[..., None]) & (torch.fmod(j, 8.0) == lane)
    r = seq_sum0(torch.where(sel, x[..., None], 0.0))
    r = [r[..., k] for k in range(8)]
    acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    k = torch.arange(7, dtype=x.dtype, device=x.device).reshape(7, *[1] * (x.dim() - 1))
    idx = (start + m + k).expand(7, *x.shape[1:])
    rest = torch.gather(x, 0, torch.clamp(idx, 0, x.shape[0] - 1).long())
    rest = torch.where(m + k < n, rest, 0.0)
    return add_all([acc] + [rest[i] for i in range(7)])


def _pairwise(x, pos, start, n, cap: int):
    """numpy's ``pairwise_sum`` of ``n <= cap`` elements from ring position
    ``start``: above 128 elements it halves (rounded down to a multiple of 8)
    and adds the two halves' sums. ``cap`` is static, so the recursion is too."""
    if cap <= 128:
        return _pairwise_block(x, pos, start, n)
    half = torch.floor(n * 0.5)
    n2 = half - torch.fmod(half, 8.0)
    split = _pairwise(x, pos, start, n2, cap // 2) + _pairwise(
        x, pos, start + n2, n - n2, (cap + 1) // 2 + 7
    )
    return torch.where(n > 128, split, _pairwise_block(x, pos, start, n))


def _window_sum(x, age, w):
    """``H.sum(axis=0)`` of ``H``, the newest ``w`` slots of the (W, N, S) ring
    ``x``, in numpy's order: left to right with several seeds, pairwise with one
    (then ``H`` is one contiguous column)."""
    if x.shape[-1] > 1:
        return seq_sum0(torch.where(age < w, x, 0.0))
    W = x.shape[0]
    return _pairwise(x, (W - 1) - age, W - w, w, W)


def _queue_demand(obs: KernelObs, horizon_s, slos: tuple):
    """Backlog-drain demand in req/s -- ``autoscaler._queue_demand``."""
    if len(slos) <= 1:
        return obs.queue / torch.clamp(horizon_s, min=obs.dt_s)
    return add_all(
        [
            obs.class_queue[..., c] / torch.clamp(torch.clamp(horizon_s, max=slo), min=obs.dt_s)
            for c, slo in enumerate(slos)
        ]
    )


def _push(hist, value):
    return torch.cat([hist[1:], value[None]])


def _ages(w: int, device) -> torch.Tensor:
    """(W, 1, 1) age of each ring slot: 0 for the latest observation."""
    return torch.arange(w - 1, -1, -1, dtype=torch.float64, device=device).reshape(w, 1, 1)


def _forecast(hist, age, n_obs: int, window_bins, horizon_s, dt_s):
    """Masked-window mirror of ``_RateForecaster.observe``'s return value:
    linear trend over the last ``min(n_obs, window_bins)`` rates, projected one
    horizon ahead (the last rate below 3 observations)."""
    w = torch.clamp(window_bins, max=n_obs)
    mask = age < w
    x = (w - 1) / 2.0 - age  # the centered index of _RateForecaster
    sx2 = seq_sum0(torch.where(mask, x * x, 0.0))  # quarter-integers: exact in any order
    # the numpy reference's exact arithmetic: the sum of x*(H - mean), not the
    # algebraically equal sum of x*H, since the two round differently
    mean = _window_sum(hist, age, w) / torch.clamp(w, min=1)
    slope = _window_sum(x * (hist - mean), age, w) / torch.clamp(sx2, min=_EPS)
    last = hist[-1]
    return torch.where(w >= 3, last + slope * div(horizon_s, dt_s), last)


def _mean_rate(hist, age, n_obs: int, window_bins):
    """``_RateForecaster.mean_rate`` over the masked window."""
    w = torch.clamp(window_bins, max=max(n_obs, 1))
    return _window_sum(hist, age, w) / w


def _starved_floor(target, obs):
    starved = (obs.queue >= 1) | (obs.arrival_rate > 0)
    return torch.maximum(target, starved.to(target.dtype))


def _static_kernel(fleet, classes) -> PolicyKernel:
    def step(kp, state, obs):
        return state, kp["n_replicas"].expand_as(obs.queue)[..., None]

    return PolicyKernel(
        name="static",
        param_names=("n_replicas",),
        params_of=lambda pol: {"n_replicas": float(pol.n)},
        init=lambda n, s, device: {},
        step=step,
    )


def _reactive_kernel(fleet, classes) -> PolicyKernel:
    def init(n, s, device):
        return {"last": torch.full((n, s), -np.inf, dtype=torch.float64, device=device)}

    def step(kp, state, obs):
        total = obs.replicas + obs.in_flight
        actionable = obs.t_s - state["last"] >= kp["cooldown_s"]
        starved = (total < 1) & ((obs.queue >= 1) | (obs.arrival_rate > 0))
        up = (actionable & (obs.utilization >= kp["upper"])) | starved
        down = actionable & ~starved & (obs.utilization <= kp["lower"]) & (obs.queue < 1)
        step_up = torch.clamp(torch.ceil(total * kp["scale_up_frac"]), min=1.0)
        t_up = torch.clamp(total + step_up, min=1.0)
        t_down = total - torch.clamp(torch.ceil(total * kp["scale_down_frac"]), min=1.0)
        target = torch.where(up, t_up, torch.where(down, t_down, total))
        last = torch.where(up | down, obs.t_s, state["last"])
        return {"last": last}, target[..., None]

    return PolicyKernel(
        name="reactive",
        param_names=("upper", "lower", "scale_up_frac", "scale_down_frac", "cooldown_s"),
        params_of=lambda pol: {
            "upper": float(pol.upper),
            "lower": float(pol.lower),
            "scale_up_frac": float(pol.up_frac),
            "scale_down_frac": float(pol.down_frac),
            "cooldown_s": float(pol.cooldown_s),
        },
        init=init,
        step=step,
    )


def _queue_prop_kernel(fleet, classes) -> PolicyKernel:
    slos = tuple(float(c.slo_s) for c in classes)
    mt0 = float(fleet.pools[0].service.max_throughput)

    def step(kp, state, obs):
        demand = obs.arrival_rate + _queue_demand(obs, kp["drain_s"], slos)
        per = torch.clamp(mt0 * kp["headroom"], min=_EPS)
        return state, torch.ceil(torch.clamp(demand, min=0.0) / per)[..., None]

    return PolicyKernel(
        name="queue-prop",
        param_names=("drain_s", "headroom"),
        params_of=lambda pol: {"drain_s": float(pol.drain_s), "headroom": float(pol.headroom)},
        init=lambda n, s, device: {},
        step=step,
    )


def _predictive_kernel(
    fleet, classes, reference: PredictivePolicy, max_window: int = None
) -> PolicyKernel:
    slos = tuple(float(c.slo_s) for c in classes)
    rate = float(reference._rate)  # recommend()+surface capacity: not a knob
    W = int(max_window or reference.forecaster.window_bins)

    def init(n, s, device):
        hist = torch.zeros((W, n, s), dtype=torch.float64, device=device)
        return {"hist": hist, "n_obs": 0, "age": _ages(W, device)}

    def step(kp, state, obs):
        hist = _push(state["hist"], obs.arrival_rate)
        n_obs = state["n_obs"] + 1
        age = state["age"]
        forecast = _forecast(hist, age, n_obs, kp["window_bins"], kp["horizon_s"], obs.dt_s)
        demand = torch.maximum(forecast, obs.arrival_rate) + _queue_demand(
            obs, kp["horizon_s"], slos
        )
        per = torch.clamp(rate * kp["headroom"], min=_EPS)
        target = torch.ceil(torch.clamp(demand, min=0.0) / per)
        return {"hist": hist, "n_obs": n_obs, "age": age}, target[..., None]

    return PolicyKernel(
        name="predictive",
        param_names=("horizon_s", "window_bins", "headroom"),
        params_of=lambda pol: {
            "horizon_s": float(pol.horizon_s),
            "window_bins": float(pol.forecaster.window_bins),
            "headroom": float(pol.headroom),
        },
        init=init,
        step=step,
    )


def _hetero_kernel(
    fleet,
    classes,
    reference: HeterogeneousPredictivePolicy,
    max_window: int = None,
    max_sustain: int = None,
) -> PolicyKernel:
    P = fleet.n_pools
    C = len(classes)
    slos = tuple(float(c.slo_s) for c in classes)
    mt = [float(p.service.max_throughput) for p in fleet.pools]
    base = int(reference.base_idx)
    burst = tuple(int(i) for i in reference.burst_idx)
    W = int(max_window or reference.forecaster.window_bins)
    Ws = int(max_sustain or reference.sustain.window_bins)
    lag = max(fleet.pools[i].cold_start_mean_s for i in burst) if burst else 0.0
    crit = [c for c, slo in enumerate(slos) if slo <= lag]  # too tight for burst cold starts

    def init(n, s, device):
        return {
            "hist": torch.zeros((W, n, s), dtype=torch.float64, device=device),
            "sustain": torch.zeros((Ws, n, s), dtype=torch.float64, device=device),
            "n_obs": 0,
            "age": _ages(W, device),
            "age_s": _ages(Ws, device),
        }

    def step(kp, state, obs):
        hist = _push(state["hist"], obs.arrival_rate)
        sustain = _push(state["sustain"], obs.arrival_rate)
        n_obs = state["n_obs"] + 1
        forecast = _forecast(
            hist, state["age"], n_obs, kp["window_bins"], kp["horizon_s"], obs.dt_s
        )
        demand = torch.clamp(
            torch.maximum(forecast, obs.arrival_rate)
            + _queue_demand(obs, kp["horizon_s"], slos),
            min=0.0,
        )
        per = [torch.clamp(m * kp["headroom"], min=_EPS) for m in mt]
        base_demand = _mean_rate(sustain, state["age_s"], n_obs, kp["sustain_bins"])
        if C > 1 and burst and crit:
            h = [
                torch.clamp(torch.clamp(kp["horizon_s"], max=slos[c]), min=obs.dt_s)
                for c in crit
            ]
            rate = add_all([obs.class_arrival_rate[..., c] for c in crit])
            drain = add_all([obs.class_queue[..., c] / h[k] for k, c in enumerate(crit)])
            base_demand = torch.maximum(base_demand, rate + drain)
        lo, hi = obs.min_replicas, obs.max_replicas
        base_n = torch.clamp(
            torch.ceil(base_demand / per[base]), min=lo[..., base], max=hi[..., base]
        )
        residual = torch.clamp(demand - base_n * per[base], min=0.0)
        target = [torch.zeros_like(demand)] * P
        for i in burst:
            n = torch.clamp(torch.ceil(residual / per[i]), min=lo[..., i], max=hi[..., i])
            target[i] = n
            residual = torch.clamp(residual - n * per[i], min=0.0)
        target[base] = torch.clamp(
            base_n + torch.ceil(residual / per[base]), min=lo[..., base], max=hi[..., base]
        )
        state = dict(state, hist=hist, sustain=sustain, n_obs=n_obs)
        return state, torch.stack(target, -1)

    return PolicyKernel(
        name="hetero-predictive",
        param_names=("horizon_s", "window_bins", "sustain_bins", "headroom"),
        params_of=lambda pol: {
            "horizon_s": float(pol.horizon_s),
            "window_bins": float(pol.forecaster.window_bins),
            "sustain_bins": float(pol.sustain.window_bins),
            "headroom": float(pol.headroom),
        },
        init=init,
        step=step,
    )


def _pi_error(prm, obs, use_queue: bool, mt0: float):
    """The PI(D) error term -- ``PIPolicy._error``'s exact arithmetic."""
    if use_queue:
        cap = torch.clamp(prm["n_base"] * mt0 * obs.dt_s, min=_EPS)
        v = obs.queue / cap
    else:
        v = obs.utilization
    return v - prm["setpoint"]


def _pi_kernel(fleet, classes, reference: PIPolicy) -> PolicyKernel:
    mt0 = float(fleet.pools[0].service.max_throughput)
    use_queue = reference.signal == "queue"

    def init(n, s, device):
        return {"i": torch.zeros((n, s), dtype=torch.float64, device=device)}

    def step(prm, state, obs):
        e = _pi_error(prm, obs, use_queue, mt0)
        i = torch.clamp(state["i"] + e, min=-prm["windup"], max=prm["windup"])
        target = torch.clamp(torch.round(prm["n_base"] + prm["kp"] * e + prm["ki"] * i), min=0.0)
        return {"i": i}, _starved_floor(target, obs)[..., None]

    return PolicyKernel(
        name="pi",
        param_names=("n_base", "kp", "ki", "setpoint", "windup"),
        params_of=lambda pol: {
            "n_base": float(pol.n_base),
            "kp": float(pol.kp),
            "ki": float(pol.ki),
            "setpoint": float(pol.setpoint),
            "windup": float(pol.windup),
        },
        init=init,
        step=step,
    )


def _pid_kernel(fleet, classes, reference: PIDPolicy) -> PolicyKernel:
    mt0 = float(fleet.pools[0].service.max_throughput)
    use_queue = reference.signal == "queue"

    def init(n, s, device):
        zeros = torch.zeros((n, s), dtype=torch.float64, device=device)
        return {"i": zeros, "prev": zeros}

    def step(prm, state, obs):
        e = _pi_error(prm, obs, use_queue, mt0)
        i = torch.clamp(state["i"] + e, min=-prm["windup"], max=prm["windup"])
        d = e - state["prev"]
        target = torch.clamp(
            torch.round(prm["n_base"] + prm["kp"] * e + prm["ki"] * i + prm["kd"] * d), min=0.0
        )
        return {"i": i, "prev": e}, _starved_floor(target, obs)[..., None]

    return PolicyKernel(
        name="pid",
        param_names=("n_base", "kp", "ki", "kd", "setpoint", "windup"),
        params_of=lambda pol: {
            "n_base": float(pol.n_base),
            "kp": float(pol.kp),
            "ki": float(pol.ki),
            "kd": float(pol.kd),
            "setpoint": float(pol.setpoint),
            "windup": float(pol.windup),
        },
        init=init,
        step=step,
    )


def _fit_to_usage_kernel(
    fleet, classes, reference: FitToUsagePolicy, max_window: int = None
) -> PolicyKernel:
    W = int(max_window or reference.window_bins)

    def init(n, s, device):
        hist = torch.zeros((W, n, s), dtype=torch.float64, device=device)
        return {"hist": hist, "n_obs": 0, "age": _ages(W, device)}

    def step(prm, state, obs):
        used = obs.utilization * torch.clamp(obs.replicas, min=0.0)
        hist = _push(state["hist"], used)
        n_obs = state["n_obs"] + 1
        w = torch.clamp(prm["window_bins"], max=n_obs)
        fit = torch.amax(torch.where(state["age"] < w, hist, -np.inf), dim=0)
        target = torch.ceil(fit * (1.0 + prm["headroom"]))
        state = dict(state, hist=hist, n_obs=n_obs)
        return state, _starved_floor(target, obs)[..., None]

    return PolicyKernel(
        name="fit-to-usage",
        param_names=("headroom", "window_bins"),
        params_of=lambda pol: {
            "headroom": float(pol.headroom),
            "window_bins": float(pol.window_bins),
        },
        init=init,
        step=step,
    )


_KERNEL_CACHE: dict = {}


def _kernel_key(policy, fleet, classes, max_window, max_sustain):
    """Config tuple fully determining a kernel's closures -- identical configs
    share one kernel object, so the backend's cold/warm dispatch classifier
    keeps recognising repeated rounds and simulations."""
    slos = tuple(float(c.slo_s) for c in classes)
    if type(policy) is StaticPolicy:
        return ("static",)
    if type(policy) is ReactivePolicy:
        return ("reactive",)
    if type(policy) is QueueProportionalPolicy:
        return ("queue-prop", float(fleet.pools[0].service.max_throughput), slos)
    if type(policy) is PredictivePolicy:
        W = int(max_window or policy.forecaster.window_bins)
        return ("predictive", float(policy._rate), W, slos)
    if type(policy) is PIPolicy or type(policy) is PIDPolicy:
        return (policy.name, policy.signal, float(fleet.pools[0].service.max_throughput))
    if type(policy) is FitToUsagePolicy:
        return ("fit-to-usage", int(max_window or policy.window_bins))
    if type(policy) is HeterogeneousPredictivePolicy:
        W = int(max_window or policy.forecaster.window_bins)
        Ws = int(max_sustain or policy.sustain.window_bins)
        mt = tuple(float(p.service.max_throughput) for p in fleet.pools)
        cs = tuple(float(p.cold_start_mean_s) for p in fleet.pools)
        burst = tuple(int(i) for i in policy.burst_idx)
        return ("hetero-predictive", mt, cs, int(policy.base_idx), burst, W, Ws, slos)
    return None


def make_kernel(policy, fleet, classes, *, max_window: int = None, max_sustain: int = None):
    """Build the :class:`PolicyKernel` for ``policy``'s family, or ``None``
    when the family has no kernel (custom Python policies run on the numpy
    reference path). ``policy`` doubles as the reference instance for the
    family's non-tunable structure (capacity rate, base/burst split);
    ``max_window``/``max_sustain`` set ring-buffer sizes when batching
    candidates with different window knobs. Kernels are cached by config, so
    equal configs return the *same* object."""
    key = _kernel_key(policy, fleet, classes, max_window, max_sustain)
    if key is None:
        return None
    kernel = _KERNEL_CACHE.get(key)
    telemetry.counter("fleet_kernel_cache_total", result="hit" if kernel is not None else "miss")
    if kernel is not None:
        return kernel
    if type(policy) is StaticPolicy:
        kernel = _static_kernel(fleet, classes)
    elif type(policy) is ReactivePolicy:
        kernel = _reactive_kernel(fleet, classes)
    elif type(policy) is QueueProportionalPolicy:
        kernel = _queue_prop_kernel(fleet, classes)
    elif type(policy) is PredictivePolicy:
        kernel = _predictive_kernel(fleet, classes, policy, max_window=max_window)
    elif type(policy) is PIPolicy:
        kernel = _pi_kernel(fleet, classes, policy)
    elif type(policy) is PIDPolicy:
        kernel = _pid_kernel(fleet, classes, policy)
    elif type(policy) is FitToUsagePolicy:
        kernel = _fit_to_usage_kernel(fleet, classes, policy, max_window=max_window)
    else:
        kernel = _hetero_kernel(
            fleet, classes, policy, max_window=max_window, max_sustain=max_sustain
        )
    _KERNEL_CACHE[key] = kernel
    return kernel
