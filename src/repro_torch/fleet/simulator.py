"""Discrete-time fleet queueing simulator, numpy-vectorized over Monte Carlo
seeds, with heterogeneous per-shape replica pools and multi-class workloads
under pluggable scheduling disciplines.

Each time bin: per-class arrivals join the queue (admission control drops
overflow *at arrival*, before it can distort anyone's waiting time, shedding
the classes the discipline values least first); the backlog is drained across
the fleet's pools in cost-efficiency order — the head of the queue goes to the
cheapest capacity first — while the scheduling discipline (FIFO / strict
priority / EDF, ``repro_torch.fleet.discipline``) decides *which class's* cohorts
that capacity serves; every ready replica drains back-to-back batches whose
service time comes from its pool's ``ServiceModel`` (roofline-derived); the
autoscaling policy observes (arrival rate, per-class queue, utilization,
per-pool replicas) and sets per-pool replica targets. Scale-downs first cancel
pending cold-starts newest-first (a cancelled launch stops billing
immediately), then shrink ready replicas; scale-ups become ready only after
the pool's cold-start delay and are billed from their launch bin — cold
capacity costs money before it serves anything.

Latency is exact, not fluid: per-slot per-class served masses feed the
request-cohort model (``repro_torch.fleet.cohort``), which recovers per-request
sojourns and deadline misses from per-class cumulative arithmetic (service
within a class is FIFO under every discipline). All per-bin state is an
(n_seeds,) / (n_seeds, n_pools) / (n_seeds, n_classes) vector, so one pass
simulates every Monte Carlo draw of the trace at once — the fleet-level
analogue of the paper's nested-loop simulation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.cost_model import dollar_cost
from repro_torch.fleet import telemetry
from repro_torch.fleet.cohort import multiclass_cohort_metrics
from repro_torch.fleet.discipline import CohortQueue, get_discipline
from repro_torch.fleet.traces import Trace
from repro_torch.fleet.workload import ServiceModel, Workload

_EPS = 1e-12


@dataclass(frozen=True)
class PoolConfig:
    """One homogeneous replica pool inside a (possibly mixed) fleet: a shape's
    service model plus its own cold start and count bounds (cloud quotas).

    ``cold_start_s`` is either a constant (seconds) or a ``(mean_s,
    jitter_frac)`` pair: each launch event then samples its spin-up delay
    from a seeded lognormal with that mean and coefficient of variation —
    real container cold starts are long-tailed, and a cooldown tuned against
    a deterministic spin-up would be fitted to a fiction. A launch event is
    one (Monte Carlo seed, bin, pool): replicas a policy grows together in
    one bin are a batched launch and share that event's draw; draws are
    independent across bins, pools, and seeds. ``jitter_frac = 0`` is
    byte-identical to the constant path."""
    service: ServiceModel
    cold_start_s: object = 30.0     # float seconds | (mean_s, jitter_frac)
    min_replicas: int = 0
    max_replicas: int = 1024
    initial_replicas: Optional[int] = None
    name: Optional[str] = None

    def __post_init__(self):
        cs = self.cold_start_s
        bad = isinstance(cs, (tuple, list)) and len(cs) != 2
        if not bad:
            m, j = self.cold_start_mean_s, self.cold_start_jitter
            bad = not (np.isfinite(m) and m >= 0
                       and np.isfinite(j) and j >= 0)
        if bad:
            raise ValueError(f"pool {self.label!r}: cold_start_s must be "
                             "non-negative seconds or a (mean_s >= 0, "
                             f"jitter_frac >= 0) pair, got {cs!r}")

    @property
    def cold_start_mean_s(self) -> float:
        if isinstance(self.cold_start_s, (tuple, list)):
            return float(self.cold_start_s[0])
        return float(self.cold_start_s)

    @property
    def cold_start_jitter(self) -> float:
        if isinstance(self.cold_start_s, (tuple, list)):
            return float(self.cold_start_s[1])
        return 0.0

    @property
    def label(self) -> str:
        return self.name or self.service.name


@dataclass(frozen=True)
class FleetConfig:
    """A fleet = per-shape pools sharing one request queue (e.g. a cheap
    ``v5e-4`` baseline pool plus ``v5e-16`` burst capacity)."""
    pools: tuple
    max_queue: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "pools", tuple(self.pools))
        if not self.pools:
            raise ValueError("FleetConfig needs at least one pool")

    @property
    def n_pools(self) -> int:
        return len(self.pools)

    def drain_order(self) -> list:
        """Pool indices cheapest-$/request first — the order the shared queue
        is drained in, so expensive burst capacity only sees overflow. Ties
        (linear cost models price every shape identically per request) go to
        the finer-grained pool: that is the baseline capacity a deployer keeps
        busy, the coarse pool being burst overflow."""
        return sorted(range(len(self.pools)),
                      key=lambda i: (self.pools[i].service.usd_per_request,
                                     self.pools[i].service.shape.price_per_hour,
                                     self.pools[i].label))

    def shape_label(self) -> str:
        names = []
        for p in self.pools:
            if p.service.shape.name not in names:
                names.append(p.service.shape.name)
        return "+".join(names)


@dataclass
class FleetObs:
    """What a policy sees at the end of a bin (arrays are (n_seeds,) unless
    noted). Homogeneous policies read the aggregate fields; per-pool policies
    read ``pool_replicas``/``pool_in_flight``/``pools``; class-aware policies
    read ``class_queue``/``class_arrival_rate``/``classes``."""
    t_s: float                  # sim time at bin end
    dt_s: float
    arrival_rate: np.ndarray    # requests/s observed this bin (all classes)
    queue: np.ndarray           # backlog after serving/drops (all classes)
    replicas: np.ndarray        # ready replicas this bin (all pools)
    in_flight: np.ndarray       # replicas still cold-starting (all pools)
    utilization: np.ndarray     # served / capacity this bin, in [0, 1]
    service: ServiceModel       # pool 0's service (homogeneous fleets)
    pool_replicas: np.ndarray = None    # (n_seeds, n_pools) ready per pool
    pool_in_flight: np.ndarray = None   # (n_seeds, n_pools) cold-starting
    pools: tuple = ()                   # the fleet's PoolConfigs
    class_queue: np.ndarray = None      # (n_seeds, n_classes) backlog
    class_arrival_rate: np.ndarray = None  # (n_seeds, n_classes) req/s
    classes: tuple = ()                 # the workload's RequestClasses


@dataclass
class SimResult:
    trace: Trace                # aggregate stream (multi-class: the sum)
    fleet: FleetConfig
    policy_name: str
    slo_s: float                # multi-class: the tightest class SLO
    # (n_seeds, n_bins) traces:
    arrivals: np.ndarray
    admitted: np.ndarray        # arrivals minus admission-control drops
    served: np.ndarray
    dropped: np.ndarray
    queue: np.ndarray
    replicas: np.ndarray        # ready (serving) replicas, all pools
    billed_replicas: np.ndarray  # ready + cold-starting (the cloud bill)
    latency_s: np.ndarray       # per-bin mean sojourn of served reqs (exact)
    ok_served: np.ndarray       # served mass meeting its class SLO (exact)
    utilization: np.ndarray
    # (n_seeds, n_bins, n_pools) traces:
    pool_replicas: np.ndarray
    pool_billed: np.ndarray
    pool_served: np.ndarray
    # exact pooled per-request sojourn distribution (across seeds/classes):
    sojourn_values: np.ndarray = field(repr=False, default=None)
    sojourn_weights: np.ndarray = field(repr=False, default=None)
    # multi-class accounting (single-class sims carry one class):
    workload: Workload = field(repr=False, default=None)
    discipline: str = "fifo"
    # (n_seeds, n_bins, n_classes) traces:
    class_admitted: np.ndarray = field(repr=False, default=None)
    class_served: np.ndarray = field(repr=False, default=None)
    class_dropped: np.ndarray = field(repr=False, default=None)
    class_queue: np.ndarray = field(repr=False, default=None)
    class_ok: np.ndarray = field(repr=False, default=None)
    # per-class exact sojourn distributions: ((values, weights), ...):
    class_sojourns: tuple = field(repr=False, default=())
    # fidelity knobs of the run (coarse bin-granular core: 1 / False):
    n_substeps: int = 1
    preemptive: bool = False
    # substep-core extras, (n_seeds, n_bins) or None on the coarse core:
    preemptions: np.ndarray = field(repr=False, default=None)
    preempted_work: np.ndarray = field(repr=False, default=None)  # batch-s
    residue_work: np.ndarray = field(repr=False, default=None)    # batch-s

    @property
    def classes(self) -> tuple:
        return self.workload.classes if self.workload is not None else ()

    @property
    def service(self) -> ServiceModel:
        return self.fleet.pools[0].service

    @property
    def cold_start_s(self) -> float:
        return self.fleet.pools[0].cold_start_mean_s

    @property
    def dt_s(self) -> float:
        return self.trace.dt_s

    def replica_bins(self) -> float:
        """Mean (over seeds) total billed replica-bins — the billing integral.
        Cold-starting replicas cost money before they serve anything."""
        return float(self.billed_replicas.sum(axis=1).mean())

    def billed_usd(self) -> float:
        """Mean (over seeds) dollar bill, summed over pools at each pool's own
        shape price."""
        usd = 0.0
        for p, pc in enumerate(self.fleet.pools):
            bins = float(self.pool_billed[:, :, p].sum(axis=1).mean())
            usd += dollar_cost(self.dt_s, bins, pc.service.shape.chips,
                               pc.service.shape.hw)
        return usd


def _initial_replicas(pool: PoolConfig, rate0: float, provision: bool) -> int:
    n0 = pool.initial_replicas
    if n0 is None:
        if provision:   # provision for the trace's initial rate (a deployer's
            n0 = int(np.ceil(rate0 / max(pool.service.max_throughput, _EPS)))
        else:           # move); secondary pools start at their floor
            n0 = pool.min_replicas
    if provision:
        n0 = max(n0, 1)
    return int(np.clip(n0, max(pool.min_replicas, 1) if provision
                       else pool.min_replicas, pool.max_replicas))


def _cold_start_plan(pools, dt: float):
    """Per-pool cold-start discretization: (cold_bins, scan_bins, jittered,
    cs_mu, cs_sigma). ``scan_bins`` bounds how far ahead a jittered launch
    can land (the ~99.9th-percentile delay, longer draws clipped there)."""
    cold_bins = [max(int(round(p.cold_start_mean_s / dt)), 0) for p in pools]
    # lognormal jitter: sigma^2 = ln(1 + jitter^2) keeps the sampled mean at
    # exactly cold_start_mean_s; pend/scan slack covers the ~99.9th-percentile
    # delay (longer draws are clipped there)
    cs_sigma = [np.sqrt(np.log1p(p.cold_start_jitter ** 2)) for p in pools]
    cs_mu = [np.log(max(p.cold_start_mean_s, _EPS)) - sg * sg / 2
             for p, sg in zip(pools, cs_sigma)]
    scan_bins = [cb if p.cold_start_jitter == 0 or p.cold_start_mean_s == 0
                 else max(int(np.ceil(np.exp(m + 3.1 * sg) / dt)), cb, 1)
                 for p, cb, m, sg in zip(pools, cold_bins, cs_mu, cs_sigma)]
    jittered = [p.cold_start_jitter > 0 and p.cold_start_mean_s > 0
                for p in pools]
    return cold_bins, scan_bins, jittered, cs_mu, cs_sigma


def draw_cold_start_delays(pools, n_seeds: int, n_bins: int, dt_s: float,
                           cold_start_seed: int, seed_ids) -> np.ndarray:
    """Pre-draw every (seed row, bin, jittered pool) spin-up delay, one
    substream per (cold_start_seed, absolute seed, pool): the draws a row
    sees depend only on its absolute identity, never on which slice of the
    workload it is simulated in or on the policy — the paired-replicate
    property candidate tuning relies on. Returns the (n_seeds, n_bins,
    n_pools) tensor, or ``None`` when no pool is jittered. A tuning scenario
    hoists this tensor out of the per-candidate loop
    (``TuningScenario.cold_start_delays``)."""
    _, _, jittered, cs_mu, cs_sigma = _cold_start_plan(pools, dt_s)
    if not any(jittered):
        return None
    P = len(pools)
    cs_delay = np.zeros((n_seeds, n_bins, P))
    for p in range(P):
        if not jittered[p]:
            continue
        for i, g in enumerate(seed_ids):
            row_rng = np.random.default_rng((cold_start_seed, int(g), p))
            cs_delay[i, :, p] = row_rng.lognormal(cs_mu[p], cs_sigma[p],
                                                  size=n_bins)
    return cs_delay


def _assemble_result(workload, fleet: FleetConfig, disc, policy_name: str,
                     order, slos, admitted, cls, rec, pool_rep, pool_billed,
                     slot_served, slot_class, slot_bt, *,
                     n_substeps: int = 1, preemptive: bool = False,
                     slot_order=None, admitted_fine=None,
                     extras=None, record_telemetry: bool = True) -> SimResult:
    """Exact per-request latency + SimResult from the dynamics arrays — the
    post-loop half of the simulation, shared by the numpy and torch backends
    (the compiled path reproduces the *dynamics*; this accounting is common).

    Slots are (substep, drain-rank) pairs, time-ordered, matching how the
    queue head was assigned; within a class every discipline serves FIFO, so
    the per-class cumulative served counts recover exact sojourns. On the
    coarse core a substep is a whole bin and slots are (bin, pool drain
    rank); the substep core subdivides each bin into ``n_substeps``
    micro-steps of ``M = slot_served.shape[2]`` slots each (a completion +
    a fluid-pour slot per pool), with ``slot_order`` naming each slot rank's
    pool and ``admitted_fine`` placing admissions at substep granularity."""
    trace = workload.total_trace()
    S, T = admitted.shape
    P = fleet.n_pools
    n = int(n_substeps)
    M = slot_served.shape[2]        # slots per substep (P coarse, 2P fine)
    U = T * n                       # total substeps
    dt = trace.dt_s
    dt_sub = dt / n
    if slot_order is None:
        slot_order = list(order)
    adm_fine = cls["admitted"] if admitted_fine is None else admitted_fine
    slot_bin = np.repeat(np.arange(U), M)
    flat_bt = slot_bt.reshape(S, U * M)
    cms = multiclass_cohort_metrics(adm_fine, slot_class, slot_bin,
                                    flat_bt, dt_sub, slos)
    class_ok = np.stack([cm.ok_served.reshape(S, T, n * M).sum(axis=2)
                         for cm in cms], axis=2)
    C = len(cms)
    class_served = slot_class.reshape(S, T, n * M, C).sum(axis=2)
    # per-bin mean sojourn pooled over classes and slots
    mass_soj = sum((cm.mean_sojourn * slot_class[:, :, c])
                   .reshape(S, T, n * M).sum(axis=2)
                   for c, cm in enumerate(cms))
    served_all = rec["served"]
    lat = np.divide(mass_soj, served_all,
                    out=np.zeros((S, T)), where=served_all > 0)
    # slots are drain-rank-ordered; report per-pool served in pool order
    su = slot_served.reshape(S, T, n * M)
    pool_served = np.stack(
        [su[:, :, [i * M + r for i in range(n)
                   for r, q in enumerate(slot_order) if q == p]].sum(axis=2)
         for p in range(P)], axis=2)
    extras = extras or {}

    result = SimResult(
        trace=trace, fleet=fleet, policy_name=policy_name,
        slo_s=float(slos.min()),
        arrivals=trace.arrivals.astype(float), admitted=admitted,
        served=served_all, dropped=rec["dropped"], queue=rec["queue"],
        replicas=rec["replicas"], billed_replicas=rec["billed"],
        latency_s=lat, ok_served=class_ok.sum(axis=2),
        utilization=rec["util"], pool_replicas=pool_rep,
        pool_billed=pool_billed, pool_served=pool_served,
        sojourn_values=np.concatenate([cm.sojourn_values for cm in cms]),
        sojourn_weights=np.concatenate([cm.sojourn_weights for cm in cms]),
        workload=workload, discipline=disc.name,
        class_admitted=cls["admitted"], class_served=class_served,
        class_dropped=cls["dropped"], class_queue=cls["queue"],
        class_ok=class_ok,
        class_sojourns=tuple((cm.sojourn_values, cm.sojourn_weights)
                             for cm in cms),
        n_substeps=n, preemptive=bool(preemptive),
        preemptions=extras.get("preemptions"),
        preempted_work=extras.get("preempted_work"),
        residue_work=extras.get("residue_work"))
    # Both backends funnel their dynamics through this one assembly path, so
    # an active telemetry session sees identical streams from either; the
    # hook only *reads* the finished result (no-op when disabled).
    # ``record_telemetry=False`` marks an interim prefix assembly of a
    # segmented run — the closed-loop controller peeks at the trace-so-far
    # without double-counting it in an active session.
    if record_telemetry:
        telemetry.record(result, slot_bt=slot_bt, slot_served=slot_served,
                         order=slot_order)
    return result


def _resolve_backend(backend: str, fleet: FleetConfig, policy, classes):
    """Map backend="numpy"|"torch"|"auto" to the engine, "numpy" or "torch".
    "auto" chooses by the policy alone: the compiled path when its family has
    a kernel, numpy for policies with none (custom Python subclasses); an
    explicit "torch" raises instead of silently changing semantics. Neither
    looks at which devices are present: the torch backend runs where
    ``device`` says, and raises there if it cannot."""
    if backend not in ("numpy", "torch", "auto"):
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'numpy', 'torch' or 'auto'")
    if backend == "numpy":
        return "numpy"
    kernel = policy.kernel(fleet, classes) \
        if hasattr(policy, "kernel") else None
    if kernel is None:
        if backend == "torch":
            raise ValueError(
                f"backend='torch': policy {getattr(policy, 'name', policy)!r} "
                "has no compiled kernel (custom Python policies run on the "
                "numpy reference path; use backend='auto' to fall back)")
        return "numpy"
    return "torch"


def simulate_fleet(workload, fleet: FleetConfig, policy, *,
                   slo_s: float = None, max_queue: float = None,
                   discipline="fifo", cold_start_seed: int = 0,
                   seed_indices=None, backend: str = "numpy",
                   cold_start_delays=None, n_substeps: int = 1,
                   preemptive: bool = False, device=None) -> SimResult:
    """Run ``policy`` against a ``Workload`` (or bare ``Trace``) on a
    heterogeneous ``fleet``.

    ``workload`` is either a multi-class ``Workload`` (per-class SLOs come
    from its ``RequestClass``es; ``slo_s`` must be omitted) or a single-class
    ``Trace`` (``slo_s`` required, the pre-multi-class calling convention).
    ``discipline`` picks the scheduling order across classes — ``"fifo"``,
    ``"priority"``, ``"edf"`` or a ``Discipline`` instance; single-class
    workloads behave identically under all of them.

    ``max_queue`` bounds the backlog (admission control): overflow is dropped
    on arrival — shedding the classes the discipline values least first — and
    counted as an SLO violation. ``None`` = unbounded (or the fleet's own
    ``max_queue``). Per-pool policies (``policy.per_pool``) return
    (n_seeds, n_pools) targets; plain policies require a single-pool fleet.

    ``cold_start_seed`` seeds the per-launch spin-up jitter of pools whose
    ``cold_start_s`` is a (mean, jitter) pair; with only constant cold starts
    it is unused and the simulation path is byte-identical to earlier
    revisions. Each Monte Carlo row draws from its own substream keyed by
    (``cold_start_seed``, absolute seed index, pool), so simulating a seed
    *slice* of a workload reproduces exactly the draws the full workload
    would give those rows — ``seed_indices`` (default ``arange(n_seeds)``)
    names the absolute indices of the rows being simulated.
    ``cold_start_delays`` (optional) supplies that (n_seeds, n_bins,
    n_pools) jitter tensor pre-drawn (``draw_cold_start_delays``), so a
    tuning round stops re-drawing identical values per candidate.

    ``backend`` selects the implementation: ``"numpy"`` (the reference
    Python loop), ``"torch"`` (the batched float64 bin loop of
    ``repro_torch.fleet.torchsim`` — requires the policy family to have a
    functional kernel), or ``"auto"`` (torch when the family has a kernel,
    numpy otherwise). Both backends produce the same ``SimResult`` up to
    float rounding (bit for bit on the substep core); the exact per-request
    latency accounting is shared. ``device`` is where the torch backend runs:
    ``None`` means the card (raising when there is none), ``"cpu"`` the CPU.

    ``n_substeps`` / ``preemptive`` pick the simulator fidelity.
    ``n_substeps=1`` with ``preemptive=False`` (the default) is the coarse
    bin-granular fluid core — byte-identical to earlier revisions on both
    backends. ``n_substeps > 1`` subdivides every bin into that many
    micro-steps and switches to the substep engine: batch service becomes an
    explicit checkpoint-resume residue (in-flight work survives bin
    boundaries and scale-downs), and with ``preemptive=True`` a strictly
    lower-keyed head-of-queue cohort interrupts a running batch at substep
    boundaries (EDF / strict priority; FIFO keys never outrank a running
    batch, so FIFO is unaffected). Policies observe bin-aggregated signals
    either way.
    """
    if isinstance(workload, Trace):
        if slo_s is None:
            raise ValueError("slo_s is required when simulating a bare Trace")
        workload = Workload.from_trace(workload, slo_s)
    elif slo_s is not None:
        raise ValueError("slo_s comes from the Workload's RequestClasses; "
                         "pass one or the other, not both")
    n_substeps = int(n_substeps)
    if n_substeps < 1:
        raise ValueError(f"n_substeps must be >= 1, got {n_substeps}")
    disc = get_discipline(discipline)
    classes = workload.classes
    C = len(classes)
    slos = workload.slos()
    trace = workload.total_trace()
    pools = fleet.pools
    P = len(pools)
    per_pool = bool(getattr(policy, "per_pool", False))
    if P > 1 and not per_pool:
        raise ValueError(f"policy {policy.name!r} returns a single target; "
                         f"a {P}-pool fleet needs a per-pool policy "
                         "(e.g. HeterogeneousPredictivePolicy)")
    if max_queue is None:
        max_queue = fleet.max_queue
    order = fleet.drain_order()
    S, T = trace.arrivals.shape
    dt = trace.dt_s
    cold_bins, scan_bins, jittered, _, _ = _cold_start_plan(pools, dt)
    max_cb = max(scan_bins)
    seed_ids = (np.arange(S) if seed_indices is None
                else np.asarray(seed_indices, int))
    if len(seed_ids) != S:
        raise ValueError(f"seed_indices names {len(seed_ids)} rows for "
                         f"a {S}-seed workload")
    if cold_start_delays is not None:
        cs_delay = np.asarray(cold_start_delays, float)
        if cs_delay.shape != (S, T, P):
            raise ValueError(f"cold_start_delays shape {cs_delay.shape} != "
                             f"{(S, T, P)}")
    else:
        cs_delay = draw_cold_start_delays(pools, S, T, dt, cold_start_seed,
                                          seed_ids)
    if _resolve_backend(backend, fleet, policy, classes) == "torch":
        return _simulate_fleet_torch(workload, fleet, policy, disc, max_queue,
                                     cs_delay, n_substeps, preemptive, device)
    if n_substeps > 1 or preemptive:
        return _simulate_fleet_substep(workload, fleet, policy, disc, order,
                                       slos, max_queue, cs_delay, n_substeps,
                                       preemptive)
    svc_terms = [(p.service.t_fixed, p.service.t_per_unit,
                  float(p.service.max_batch)) for p in pools]

    policy.reset(S)
    ready = np.zeros((S, P))
    for p, pc in enumerate(pools):
        ready[:, p] = _initial_replicas(pc, trace.rate[0], p == order[0])
    cq = CohortQueue(disc, classes, S, T, dt)   # per-class queue state
    arrivals_c = workload.arrivals.astype(float)  # (S, T, C)
    pend = np.zeros((S, T + max_cb + 2, P))   # scale-ups maturing per bin
    in_flight = np.zeros((S, P))              # running sum of future pend

    slot_served = np.zeros((S, T, P))         # per (bin, drain-rank) mass
    slot_class = np.zeros((S, T * P, C))      # ...split across classes
    slot_bt = np.zeros((S, T, P))             # batch time of that slot
    admitted = np.zeros((S, T))
    cls = {k: np.zeros((S, T, C)) for k in
           ("admitted", "dropped", "queue")}
    rec = {k: np.zeros((S, T)) for k in
           ("served", "dropped", "queue", "replicas", "billed", "util")}
    pool_rep = np.zeros((S, T, P))
    pool_billed = np.zeros((S, T, P))

    for t in range(T):
        matured = pend[:, t, :]
        ready += matured
        in_flight -= matured
        arr_c = arrivals_c[:, t, :]
        arr = arr_c.sum(axis=1)
        # admission control happens at arrival: a dropped request never queues,
        # so it cannot inflate the sojourn of requests that are actually
        # served; overflow is shed from the arriving cohorts the discipline
        # would have served last (largest key first)
        drop_c = np.zeros((S, C))
        if max_queue is not None:
            over = np.maximum(cq.backlog().sum(axis=1) + arr - max_queue, 0.0)
            for c in cq.drop_order(t):
                d = np.minimum(arr_c[:, c], over)
                drop_c[:, c] = d
                over = over - d
        adm_c = arr_c - drop_c
        cq.admit(t, adm_c)
        admitted[:, t] = adm_c.sum(axis=1)
        cls["admitted"][:, t, :] = adm_c
        cls["dropped"][:, t, :] = drop_c
        drop = drop_c.sum(axis=1)

        # drain the shared queue across pools, cheapest capacity first; the
        # discipline decides which class's cohorts each slot's mass comes from
        remaining = cq.backlog().sum(axis=1)
        capacity = np.zeros(S)
        for rank, p in enumerate(order):
            t_fixed, t_unit, max_b = svc_terms[p]
            n = np.maximum(ready[:, p], 0.0)
            has = n > 0
            # per-replica batch: split the backlog, clipped to the batch window
            b = np.clip(np.ceil(np.divide(remaining, n, out=np.zeros(S),
                                          where=has)), 1.0, max_b)
            bt = np.maximum(t_fixed + b * t_unit, _EPS)
            cap = np.where(has, n * b / bt, 0.0) * dt
            split = cq.serve(t, np.minimum(remaining, cap))
            s_p = split.sum(axis=1)
            slot_class[:, t * P + rank, :] = split
            remaining = remaining - s_p
            capacity += cap
            slot_served[:, t, rank] = s_p
            slot_bt[:, t, rank] = bt
        queue_c = cq.backlog()
        queue = queue_c.sum(axis=1)
        cls["queue"][:, t, :] = queue_c
        served = slot_served[:, t, :].sum(axis=1)

        pool_rep[:, t, :] = ready
        n_ready = ready.sum(axis=1)
        obs = FleetObs(
            t_s=(t + 1) * dt, dt_s=dt, arrival_rate=arr / dt, queue=queue,
            replicas=n_ready, in_flight=in_flight.sum(axis=1),
            utilization=np.divide(served, capacity, out=np.zeros(S),
                                  where=capacity > 0),
            service=pools[0].service, pool_replicas=pool_rep[:, t, :],
            pool_in_flight=in_flight.copy(), pools=pools,
            class_queue=queue_c, class_arrival_rate=arr_c / dt,
            classes=classes)
        target = np.asarray(policy.decide(t, obs), float)
        if target.ndim == 1:
            target = target[:, None]

        for p, pc in enumerate(pools):
            tg = np.clip(target[:, p], pc.min_replicas, pc.max_replicas)
            excess = np.maximum(ready[:, p] + in_flight[:, p] - tg, 0.0)
            if excess.any():
                # scale down: cancel pending cold-starts newest-first (they
                # stop billing now), then shrink ready replicas
                for j in range(min(t + 1 + scan_bins[p], T + max_cb + 1),
                               t, -1):
                    col = pend[:, j, p]
                    if not col.any():
                        continue
                    cut = np.minimum(col, excess)
                    pend[:, j, p] = col - cut
                    in_flight[:, p] -= cut
                    excess -= cut
                    if not excess.any():
                        break
                ready[:, p] = np.maximum(ready[:, p] - excess, 0.0)
            grow = np.maximum(tg - ready[:, p] - in_flight[:, p], 0.0)
            if jittered[p]:
                jb = np.clip(np.rint(cs_delay[:, t, p] / dt).astype(int), 0,
                             scan_bins[p])
                idx = np.minimum(t + 1 + jb, T + max_cb + 1)
                pend[np.arange(S), idx, p] += grow
            else:
                pend[:, min(t + 1 + cold_bins[p], T + max_cb + 1), p] += grow
            in_flight[:, p] += grow
            # the bill: replicas that served this bin (even if torn down at
            # its end) plus everything cold-starting after this bin's
            # decisions — a launch is billed in its launch bin, a cancelled
            # launch is not
            pool_billed[:, t, p] = obs.pool_replicas[:, p] + in_flight[:, p]

        rec["served"][:, t] = served
        rec["dropped"][:, t] = drop
        rec["queue"][:, t] = queue
        rec["replicas"][:, t] = n_ready
        rec["billed"][:, t] = pool_billed[:, t, :].sum(axis=1)
        rec["util"][:, t] = obs.utilization

    return _assemble_result(workload, fleet, disc, policy.name, order, slos,
                            admitted, cls, rec, pool_rep, pool_billed,
                            slot_served, slot_class, slot_bt)


@dataclass
class FleetState:
    """Checkpoint of the substep engine's carried state at a bin boundary —
    everything a resumed segment needs so the stitched trace is one
    continuous run: ready/cold-starting replicas, the pending-launch ledger,
    the cumulative-admitted queue curves, and the in-flight / preempted
    batch residue (PR 7's checkpoint-resume machinery, made explicit).
    All arrays are owned and mutated in place by ``_run_substep_segment``."""
    t: int                      # next bin to simulate
    ready: np.ndarray           # (S, P) ready replicas
    in_flight: np.ndarray       # (S, P) replicas still cold-starting
    pend: np.ndarray            # (S, T + max_cb + 2, P) launches maturing
    Acum: np.ndarray            # (S, C, T + 1) cumulative admitted curves
    done: np.ndarray            # (S, C) cumulative poured totals
    busy_mass: np.ndarray       # (S, P, C) in-flight batch mass split
    busy_work: np.ndarray       # (S, P) in-flight batch work remaining
    busy_key: np.ndarray        # (S, P) in-flight batch preemption key
    held_mass: np.ndarray       # (S, P, C) checkpointed (preempted) batch
    held_work: np.ndarray       # (S, P)
    held_key: np.ndarray        # (S, P)


@dataclass
class _SubstepBuffers:
    """Full-trace output arrays of a (possibly segmented) substep run; each
    segment fills its own bin range."""
    slot_served: np.ndarray     # (S, U, M) per (substep, slot) served mass
    slot_class: np.ndarray      # (S, U * M, C) ...split across classes
    slot_bt: np.ndarray         # (S, U, M) batch time of that slot
    admitted_fine: np.ndarray   # (S, U, C) admissions at substep granularity
    admitted: np.ndarray        # (S, T)
    cls: dict                   # (S, T, C) admitted / dropped / queue
    rec: dict                   # (S, T) served / dropped / ... / util
    pool_rep: np.ndarray        # (S, T, P)
    pool_billed: np.ndarray     # (S, T, P)
    pre_n: np.ndarray           # (S, T) preemption counts
    pre_w: np.ndarray           # (S, T) preempted work (batch-seconds)
    residue: np.ndarray         # (S, T) carried work at bin end


def _init_substep_state(workload, fleet: FleetConfig, order,
                        max_cb: int) -> FleetState:
    trace = workload.total_trace()
    S, T = trace.arrivals.shape
    C = len(workload.classes)
    P = fleet.n_pools
    ready = np.zeros((S, P))
    for p, pc in enumerate(fleet.pools):
        ready[:, p] = _initial_replicas(pc, trace.rate[0], p == order[0])
    return FleetState(
        t=0, ready=ready, in_flight=np.zeros((S, P)),
        pend=np.zeros((S, T + max_cb + 2, P)),
        # queue state: cumulative-admitted curves + poured totals (the
        # compiled backend's representation — both engines pour via the
        # same tables)
        Acum=np.zeros((S, C, T + 1)), done=np.zeros((S, C)),
        # in-flight batch per pool: mass split, remaining work, key
        busy_mass=np.zeros((S, P, C)), busy_work=np.zeros((S, P)),
        busy_key=np.full((S, P), -np.inf),
        # checkpointed (preempted) batch per pool
        held_mass=np.zeros((S, P, C)), held_work=np.zeros((S, P)),
        held_key=np.full((S, P), -np.inf))


def _alloc_substep_buffers(S, T, P, C, n: int) -> _SubstepBuffers:
    U = T * n
    M = 2 * P            # per substep: a completion + a pour slot per pool
    return _SubstepBuffers(
        slot_served=np.zeros((S, U, M)), slot_class=np.zeros((S, U * M, C)),
        slot_bt=np.zeros((S, U, M)), admitted_fine=np.zeros((S, U, C)),
        admitted=np.zeros((S, T)),
        cls={k: np.zeros((S, T, C))
             for k in ("admitted", "dropped", "queue")},
        rec={k: np.zeros((S, T)) for k in
             ("served", "dropped", "queue", "replicas", "billed", "util")},
        pool_rep=np.zeros((S, T, P)), pool_billed=np.zeros((S, T, P)),
        pre_n=np.zeros((S, T)), pre_w=np.zeros((S, T)),
        residue=np.zeros((S, T)))


def _run_substep_segment(workload, fleet: FleetConfig, policy, disc, order,
                         slos, max_queue, cs_delay, n: int, preemptive: bool,
                         tables, st: FleetState, buf: _SubstepBuffers,
                         t0: int, t1: int) -> None:
    """Advance the substep engine from bin ``t0`` to ``t1`` (exclusive),
    mutating ``st`` and filling ``buf[:, t0:t1]`` in place.

    The loop body is the substep engine's verbatim (see
    ``_simulate_fleet_substep``); a single ``[0, T)`` segment is
    byte-identical to the unsegmented run. Between calls the caller may
    swap ``policy`` or ``fleet`` (service behaviour only — the pend ledger
    and drain order are sized/pinned at allocation), which is how the
    closed-loop controller hot-swaps a policy mid-trace while PR 7's
    residue machinery carries the in-flight state across the boundary.
    Service terms and the cold-start plan are re-derived from ``fleet``
    here so a degraded fleet takes effect at the segment boundary."""
    from repro_torch.fleet.discipline import table_head_key, table_pour

    trace = workload.total_trace()
    classes = workload.classes
    C = len(classes)
    pools = fleet.pools
    P = len(pools)
    S, T = trace.arrivals.shape
    dt = trace.dt_s
    dt_sub = dt / n
    cold_bins, scan_bins, jittered, _, _ = _cold_start_plan(pools, dt)
    max_cb = st.pend.shape[1] - T - 2    # pend slack fixed at allocation
    svc_terms = [(p.service.t_fixed, p.service.t_per_unit,
                  float(p.service.max_batch)) for p in pools]
    tput = [p.service.max_throughput for p in pools]
    arrivals_c = workload.arrivals.astype(float)

    ready = st.ready
    in_flight = st.in_flight
    pend = st.pend
    Acum = st.Acum
    done = st.done
    busy_mass = st.busy_mass
    busy_work = st.busy_work
    busy_key = st.busy_key
    held_mass = st.held_mass
    held_work = st.held_work
    held_key = st.held_key
    slot_served = buf.slot_served
    slot_class = buf.slot_class
    slot_bt = buf.slot_bt
    admitted_fine = buf.admitted_fine
    admitted = buf.admitted
    cls = buf.cls
    rec = buf.rec
    pool_rep = buf.pool_rep
    pool_billed = buf.pool_billed
    pre_n = buf.pre_n
    pre_w = buf.pre_w
    residue = buf.residue
    M = 2 * P

    for t in range(t0, t1):
        matured = pend[:, t, :]
        ready += matured
        in_flight -= matured
        arr_c = arrivals_c[:, t, :]
        arr = arr_c.sum(axis=1)
        total_prev = Acum[:, :, T]
        drop_c = np.zeros((S, C))
        if max_queue is not None:
            # admission control bounds *outstanding* work: waiting mass plus
            # whatever is in flight or checkpointed on the pools
            out_c = (total_prev - done) + busy_mass.sum(axis=1) \
                + held_mass.sum(axis=1)
            over = np.maximum(out_c.sum(axis=1) + arr - max_queue, 0.0)
            for c in tables["drop_rank"][t]:
                d = np.minimum(arr_c[:, c], over)
                drop_c[:, c] = d
                over = over - d
        adm_c = arr_c - drop_c
        new_total = total_prev + adm_c
        Acum[:, :, t + 1:] = new_total[:, :, None]
        admitted[:, t] = adm_c.sum(axis=1)
        admitted_fine[:, t * n, :] = adm_c
        cls["admitted"][:, t, :] = adm_c
        cls["dropped"][:, t, :] = drop_c
        drop = drop_c.sum(axis=1)

        served_bin = np.zeros(S)
        for i in range(n):
            u = t * n + i
            for rank, p in enumerate(order):
                t_fixed, t_unit, max_b = svc_terms[p]
                n_rep = np.maximum(ready[:, p], 0.0)
                has = n_rep > 0
                tau = np.full(S, dt_sub)
                comp_m = np.zeros((S, C))
                comp_btw = np.zeros(S)
                hk = table_head_key(Acum, done, tables)
                if preemptive:
                    pr = (busy_work[:, p] > 0.0) & (hk < busy_key[:, p])
                    held_mass[:, p] += np.where(pr[:, None],
                                                busy_mass[:, p], 0.0)
                    held_work[:, p] += np.where(pr, busy_work[:, p], 0.0)
                    held_key[:, p] = np.where(
                        pr, np.maximum(held_key[:, p], busy_key[:, p]),
                        held_key[:, p])
                    pre_n[:, t] += pr
                    pre_w[:, t] += np.where(pr, busy_work[:, p], 0.0)
                    busy_mass[:, p] = np.where(pr[:, None], 0.0,
                                               busy_mass[:, p])
                    busy_work[:, p] = np.where(pr, 0.0, busy_work[:, p])
                    busy_key[:, p] = np.where(pr, -np.inf, busy_key[:, p])
                # progress the in-flight batch (.copy(): the slice is a view
                # of busy_work, which is updated before tau reads w)
                w = busy_work[:, p].copy()
                tau0 = tau
                fin = (w > 0.0) & (w <= tau0)
                run = w > tau0
                comp_m += np.where(fin[:, None], busy_mass[:, p], 0.0)
                comp_btw += np.where(
                    fin,
                    busy_mass[:, p].sum(axis=1) * ((dt_sub - tau0) + w),
                    0.0)
                busy_work[:, p] = np.where(run, w - tau0, 0.0)
                busy_mass[:, p] = np.where(fin[:, None], 0.0,
                                           busy_mass[:, p])
                busy_key[:, p] = np.where(fin, -np.inf, busy_key[:, p])
                tau = np.where(fin, tau0 - w, np.where(run, 0.0, tau0))
                # resume a checkpoint, else form a new batch from the queue
                idle = busy_work[:, p] == 0.0
                res = idle & (held_work[:, p] > 0.0) & (hk >= held_key[:, p])
                busy_mass[:, p] = np.where(res[:, None], held_mass[:, p],
                                           busy_mass[:, p])
                busy_work[:, p] = np.where(res, held_work[:, p],
                                           busy_work[:, p])
                busy_key[:, p] = np.where(res, held_key[:, p],
                                          busy_key[:, p])
                held_mass[:, p] = np.where(res[:, None], 0.0,
                                           held_mass[:, p])
                held_work[:, p] = np.where(res, 0.0, held_work[:, p])
                held_key[:, p] = np.where(res, -np.inf, held_key[:, p])

                backlog = (new_total - done).sum(axis=1)
                form = idle & (~res) & (backlog > 0.0) & (tau > 0.0) & has
                b = np.clip(np.where(has, np.ceil(
                    backlog / np.where(has, n_rep, 1.0)), 0.0), 1.0, max_b)
                bt_b = np.maximum(t_fixed + b * t_unit, _EPS)
                amt = np.where(form, np.minimum(backlog, n_rep * b), 0.0)
                split, _ = table_pour(Acum, done, amt, tables)
                done = done + split
                busy_mass[:, p] = np.where(form[:, None], split,
                                           busy_mass[:, p])
                busy_work[:, p] = np.where(form, bt_b, busy_work[:, p])
                # the batch's preemption rank is its *head* key — the most
                # urgent cohort it swept up. Ranking by the largest key
                # touched would let a fresh urgent arrival preempt a batch
                # that itself carries urgent mass, checkpointing that mass
                # behind an unresumable max-key gate (priority inversion)
                busy_key[:, p] = np.where(form, hk, busy_key[:, p])
                # progress the resumed/formed batch with the leftover budget
                w2 = busy_work[:, p].copy()
                tau0 = tau
                fin2 = (w2 > 0.0) & (w2 <= tau0)
                run2 = w2 > tau0
                comp_m += np.where(fin2[:, None], busy_mass[:, p], 0.0)
                comp_btw += np.where(
                    fin2,
                    busy_mass[:, p].sum(axis=1) * ((dt_sub - tau0) + w2),
                    0.0)
                busy_work[:, p] = np.where(run2, w2 - tau0, busy_work[:, p])
                busy_work[:, p] = np.where(fin2, 0.0, busy_work[:, p])
                busy_mass[:, p] = np.where(fin2[:, None], 0.0,
                                           busy_mass[:, p])
                busy_key[:, p] = np.where(fin2, -np.inf, busy_key[:, p])
                tau = np.where(fin2, tau0 - w2, np.where(run2, 0.0, tau0))
                # fluid tail: an idle pool's leftover budget drains the
                # queue at its instantaneous rate (the coarse convention)
                idle2 = busy_work[:, p] == 0.0
                backlog2 = (new_total - done).sum(axis=1)
                b2 = np.clip(np.where(has, np.ceil(
                    backlog2 / np.where(has, n_rep, 1.0)), 0.0), 1.0, max_b)
                bt2 = np.maximum(t_fixed + b2 * t_unit, _EPS)
                tail = idle2 & (tau > 0.0) & has
                cap = np.where(tail, n_rep * b2 / bt2, 0.0) * tau
                amt2 = np.minimum(np.maximum(backlog2, 0.0), cap)
                split2, _ = table_pour(Acum, done, amt2, tables)
                done = done + split2
                pour_tot = split2.sum(axis=1)
                comp_tot = comp_m.sum(axis=1)
                k0 = u * M + 2 * rank
                slot_class[:, k0, :] = comp_m
                slot_served[:, u, 2 * rank] = comp_tot
                # completion slot bt = mass-weighted elapsed time within the
                # substep, so sojourns include pause delays exactly
                slot_bt[:, u, 2 * rank] = np.divide(
                    comp_btw, comp_tot, out=np.zeros(S),
                    where=comp_tot > 0)
                slot_class[:, k0 + 1, :] = split2
                slot_served[:, u, 2 * rank + 1] = pour_tot
                slot_bt[:, u, 2 * rank + 1] = np.where(
                    pour_tot > 0.0, (dt_sub - tau) + bt2, 0.0)
                served_bin = served_bin + comp_tot
                served_bin = served_bin + pour_tot
            # fold sub-eps float residue of a drained class (the coarse
            # loop's _MASS_EPS behaviour, applied once per substep)
            done = np.where(new_total - done <= 1e-9 + 1e-12 * new_total,
                            new_total, done)

        out_c = np.maximum(new_total - done, 0.0) + busy_mass.sum(axis=1) \
            + held_mass.sum(axis=1)
        queue = out_c.sum(axis=1)
        cls["queue"][:, t, :] = out_c
        pool_rep[:, t, :] = ready
        n_ready = ready.sum(axis=1)
        # completions are lumpy at substep granularity, so utilization is
        # served over the pools' nameplate throughput, clipped to 1
        capacity = np.zeros(S)
        for p in range(P):
            capacity = capacity + np.maximum(ready[:, p], 0.0) \
                * tput[p] * dt
        util = np.divide(served_bin, capacity, out=np.zeros(S),
                         where=capacity > 0)
        util = np.minimum(util, 1.0)
        obs = FleetObs(
            t_s=(t + 1) * dt, dt_s=dt, arrival_rate=arr / dt, queue=queue,
            replicas=n_ready, in_flight=in_flight.sum(axis=1),
            utilization=util,
            service=pools[0].service, pool_replicas=pool_rep[:, t, :],
            pool_in_flight=in_flight.copy(), pools=pools,
            class_queue=out_c, class_arrival_rate=arr_c / dt,
            classes=classes)
        target = np.asarray(policy.decide(t, obs), float)
        if target.ndim == 1:
            target = target[:, None]

        for p, pc in enumerate(pools):
            tg = np.clip(target[:, p], pc.min_replicas, pc.max_replicas)
            excess = np.maximum(ready[:, p] + in_flight[:, p] - tg, 0.0)
            if excess.any():
                for j in range(min(t + 1 + scan_bins[p], T + max_cb + 1),
                               t, -1):
                    col = pend[:, j, p]
                    if not col.any():
                        continue
                    cut = np.minimum(col, excess)
                    pend[:, j, p] = col - cut
                    in_flight[:, p] -= cut
                    excess -= cut
                    if not excess.any():
                        break
                ready[:, p] = np.maximum(ready[:, p] - excess, 0.0)
            grow = np.maximum(tg - ready[:, p] - in_flight[:, p], 0.0)
            if jittered[p]:
                jb = np.clip(np.rint(cs_delay[:, t, p] / dt).astype(int), 0,
                             scan_bins[p])
                idx = np.minimum(t + 1 + jb, T + max_cb + 1)
                pend[np.arange(S), idx, p] += grow
            else:
                pend[:, min(t + 1 + cold_bins[p], T + max_cb + 1), p] += grow
            in_flight[:, p] += grow
            pool_billed[:, t, p] = obs.pool_replicas[:, p] + in_flight[:, p]

        rec["served"][:, t] = served_bin
        rec["dropped"][:, t] = drop
        rec["queue"][:, t] = queue
        rec["replicas"][:, t] = n_ready
        rec["billed"][:, t] = pool_billed[:, t, :].sum(axis=1)
        rec["util"][:, t] = util
        residue[:, t] = busy_work.sum(axis=1) + held_work.sum(axis=1)

    st.done = done      # the one rebound (not in-place) state array
    st.t = t1


def _assemble_substep(workload, fleet: FleetConfig, disc, policy_name,
                      order, slos, buf: _SubstepBuffers, n: int,
                      preemptive: bool, *, t1: int = None,
                      record_telemetry: bool = True) -> SimResult:
    """SimResult from (a prefix of) a substep run's buffers. ``t1`` < T
    assembles the trace-so-far of a segmented run — the closed-loop
    controller's telemetry feed — and should leave ``record_telemetry``
    off so an active session only sees the finished trace once."""
    T = buf.admitted.shape[1]
    if t1 is None:
        t1 = T
    if t1 < T:
        workload = _slice_workload_time(workload, t1)
    M = buf.slot_served.shape[2]
    u1 = t1 * n
    extras = {"preemptions": buf.pre_n[:, :t1],
              "preempted_work": buf.pre_w[:, :t1],
              "residue_work": buf.residue[:, :t1]}
    slot_order = [q for q in order for _ in range(2)]
    return _assemble_result(workload, fleet, disc, policy_name, order, slos,
                            buf.admitted[:, :t1],
                            {k: v[:, :t1] for k, v in buf.cls.items()},
                            {k: v[:, :t1] for k, v in buf.rec.items()},
                            buf.pool_rep[:, :t1], buf.pool_billed[:, :t1],
                            buf.slot_served[:, :u1],
                            buf.slot_class[:, :u1 * M],
                            buf.slot_bt[:, :u1],
                            n_substeps=n, preemptive=preemptive,
                            slot_order=slot_order,
                            admitted_fine=buf.admitted_fine[:, :u1],
                            extras=extras,
                            record_telemetry=record_telemetry)


def _slice_workload_time(workload, t1: int):
    """The first ``t1`` bins of every class trace (prefix assembly of a
    segmented run keeps arrivals and buffers on the same time axis)."""
    traces = tuple(Trace(name=tr.name, dt_s=tr.dt_s, rate=tr.rate[:t1],
                         arrivals=tr.arrivals[:, :t1])
                   for tr in workload.traces)
    return Workload(workload.name, workload.classes, traces)


def _simulate_fleet_substep(workload, fleet: FleetConfig, policy, disc,
                            order, slos, max_queue, cs_delay,
                            n_substeps: int, preemptive: bool) -> SimResult:
    """Fine-Δt numpy engine: every wall-clock bin subdivided into
    ``n_substeps`` micro-steps with checkpoint-resume batch service.

    Unlike the coarse loop (fluid service: a slot's pour departs within its
    own bin), a batch here is an explicit unit of in-flight work: it is
    poured once — a covering-prefix over the discipline's static serve-order
    tables, the *same* rule the compiled backend bisects
    (``discipline.table_pour``) — then carries a work-remaining residue
    across substeps and departs only when that residue hits zero. Under
    ``preemptive=True`` a strictly lower-keyed head-of-queue cohort
    interrupts the running batch at a substep boundary: the batch
    checkpoints (mass + remaining work + key) and resumes once no queued
    cohort outranks it. Scale-downs never kill in-flight work (connection
    draining): a shrunk pool still finishes its running batch. When a batch
    completes with substep budget to spare, the leftover drains the queue
    fluidly at the pool's instantaneous rate — the coarse within-bin
    convention, so short-batch regimes keep coarse-like throughput while
    long batches get honest head-of-line blocking.

    The policy's decision cadence, the scale-down water-fill, the
    pending-launch ledger and billing are the coarse loop's verbatim; it
    observes bin-aggregated signals. The reported queue is *outstanding*
    work (admitted - departed: waiting + in-flight + checkpointed mass), so
    served + dropped + terminal queue == arrivals stays exact.

    Every per-substep float op mirrors the compiled substep core's operation
    order one-for-one; the two are pinned bit-exact in the tests. The loop
    itself lives in ``_run_substep_segment`` (state in an explicit
    ``FleetState``), so ``SegmentedSimulation`` can run the same engine in
    checkpoint-resume segments; this single-segment path is byte-identical
    to the pre-refactor function.
    """
    from repro_torch.fleet.discipline import cohort_tables

    trace = workload.total_trace()
    classes = workload.classes
    C = len(classes)
    P = fleet.n_pools
    S, T = trace.arrivals.shape
    dt = trace.dt_s
    n = int(n_substeps)
    tables = cohort_tables(disc, classes, T, dt)
    _, scan_bins, _, _, _ = _cold_start_plan(fleet.pools, dt)

    policy.reset(S)
    st = _init_substep_state(workload, fleet, order, max(scan_bins))
    buf = _alloc_substep_buffers(S, T, P, C, n)
    _run_substep_segment(workload, fleet, policy, disc, order, slos,
                         max_queue, cs_delay, n, preemptive, tables,
                         st, buf, 0, T)
    return _assemble_substep(workload, fleet, disc, policy.name, order,
                             slos, buf, n, preemptive)


class SegmentedSimulation:
    """Checkpoint-resume driver over the substep engine: run a workload in
    bin segments, the full carried state (queues, in-flight batches,
    pending launches, batch residue) surviving every boundary, so the
    finished trace is one continuous run.

    Between segments the caller may hot-swap the policy (new params or a
    new family) and/or the fleet's *service behaviour* — the closed-loop
    controller's actuation primitive. A policy swap takes effect at the
    boundary (the incoming policy is reset; in-flight work keeps
    draining). A fleet swap models the world changing under the
    controller — e.g. ``telemetry.degrade_fleet`` inflating service times
    mid-trace — and must preserve pool count, labels and prices: hardware
    cannot be exchanged mid-trace, only how it behaves. The drain order
    and the pending-launch ledger are pinned at construction.

    ``run_until(T)`` + ``result()`` with no swaps is equivalent to
    ``simulate_fleet(..., n_substeps=n, preemptive=...)`` on the numpy
    backend (single segment: byte-identical; segmented: the same run split
    at boundaries)."""

    def __init__(self, workload, fleet: FleetConfig, policy, *,
                 slo_s: float = None, max_queue: float = None,
                 discipline="fifo", cold_start_seed: int = 0,
                 seed_indices=None, cold_start_delays=None,
                 n_substeps: int = 1, preemptive: bool = False):
        from repro_torch.fleet.discipline import cohort_tables

        if isinstance(workload, Trace):
            if slo_s is None:
                raise ValueError("slo_s is required when simulating a "
                                 "bare Trace")
            workload = Workload.from_trace(workload, slo_s)
        elif slo_s is not None:
            raise ValueError("slo_s comes from the Workload's "
                             "RequestClasses; pass one or the other")
        n = int(n_substeps)
        if n < 1:
            raise ValueError(f"n_substeps must be >= 1, got {n}")
        self.workload = workload
        self.fleet = fleet
        self.policy = policy
        self.disc = get_discipline(discipline)
        self.n_substeps = n
        self.preemptive = bool(preemptive)
        per_pool = bool(getattr(policy, "per_pool", False))
        if fleet.n_pools > 1 and not per_pool:
            raise ValueError(f"policy {policy.name!r} returns a single "
                             f"target; a {fleet.n_pools}-pool fleet needs "
                             "a per-pool policy")
        self.max_queue = fleet.max_queue if max_queue is None else max_queue
        self.order = fleet.drain_order()
        trace = workload.total_trace()
        S, T = trace.arrivals.shape
        self.n_seeds, self.n_bins = S, T
        dt = trace.dt_s
        seed_ids = (np.arange(S) if seed_indices is None
                    else np.asarray(seed_indices, int))
        if cold_start_delays is not None:
            cs_delay = np.asarray(cold_start_delays, float)
            if cs_delay.shape != (S, T, fleet.n_pools):
                raise ValueError(
                    f"cold_start_delays shape {cs_delay.shape} != "
                    f"{(S, T, fleet.n_pools)}")
        else:
            cs_delay = draw_cold_start_delays(fleet.pools, S, T, dt,
                                              cold_start_seed, seed_ids)
        self._cs_delay = cs_delay
        self._slos = workload.slos()
        self._tables = cohort_tables(self.disc, workload.classes, T, dt)
        _, scan_bins, _, _, _ = _cold_start_plan(fleet.pools, dt)
        policy.reset(S)
        self.state = _init_substep_state(workload, fleet, self.order,
                                         max(scan_bins))
        self._buf = _alloc_substep_buffers(S, T, fleet.n_pools,
                                           len(workload.classes), n)

    @property
    def t(self) -> int:
        """Next bin to simulate (bins [0, t) are done)."""
        return self.state.t

    @property
    def done(self) -> bool:
        return self.state.t >= self.n_bins

    def run_until(self, t1: int) -> "SegmentedSimulation":
        """Advance the simulation to bin ``t1`` (exclusive)."""
        t1 = int(t1)
        if not (self.state.t <= t1 <= self.n_bins):
            raise ValueError(f"run_until({t1}): segment must lie in "
                             f"[{self.state.t}, {self.n_bins}]")
        if t1 > self.state.t:
            _run_substep_segment(self.workload, self.fleet, self.policy,
                                 self.disc, self.order, self._slos,
                                 self.max_queue, self._cs_delay,
                                 self.n_substeps, self.preemptive,
                                 self._tables, self.state, self._buf,
                                 self.state.t, t1)
        return self

    def swap(self, policy=None, fleet: FleetConfig = None) \
            -> "SegmentedSimulation":
        """Hot-swap the policy and/or the fleet's service behaviour at the
        current segment boundary. The incoming policy starts fresh
        (``reset``); carried state — queue curves, in-flight batches,
        pending launches — survives untouched."""
        if self.done:
            raise ValueError("cannot swap after the final bin")
        if fleet is not None:
            self._check_fleet_swap(fleet)
            self.fleet = fleet
        if policy is not None:
            per_pool = bool(getattr(policy, "per_pool", False))
            if self.fleet.n_pools > 1 and not per_pool:
                raise ValueError(
                    f"policy {policy.name!r} returns a single target; a "
                    f"{self.fleet.n_pools}-pool fleet needs a per-pool "
                    "policy")
            policy.reset(self.n_seeds)
            self.policy = policy
        return self

    def _check_fleet_swap(self, fleet: FleetConfig) -> None:
        old = self.fleet
        if fleet.n_pools != old.n_pools:
            raise ValueError(f"fleet swap changes pool count "
                             f"({old.n_pools} -> {fleet.n_pools})")
        for p_new, p_old in zip(fleet.pools, old.pools):
            same = (p_new.label == p_old.label
                    and p_new.service.shape.name == p_old.service.shape.name
                    and p_new.service.shape.price_per_hour
                    == p_old.service.shape.price_per_hour)
            if not same:
                raise ValueError(
                    f"fleet swap must keep pool identity/pricing (pool "
                    f"{p_old.label!r} -> {p_new.label!r}); only service "
                    "behaviour may change mid-trace")
        _, scan_bins, _, _, _ = _cold_start_plan(
            fleet.pools, self.workload.dt_s)
        max_cb = self.state.pend.shape[1] - self.n_bins - 2
        if max(scan_bins) > max_cb:
            raise ValueError(
                "fleet swap lengthens the cold-start horizon beyond the "
                f"allocated launch ledger ({max(scan_bins)} > {max_cb} "
                "bins)")

    def result(self) -> SimResult:
        """The finished continuous run (requires ``run_until(n_bins)``)."""
        if not self.done:
            raise ValueError(f"simulation at bin {self.state.t} of "
                             f"{self.n_bins}; run_until the end first")
        return _assemble_substep(self.workload, self.fleet, self.disc,
                                 self.policy.name, self.order, self._slos,
                                 self._buf, self.n_substeps,
                                 self.preemptive)

    def partial_result(self, *, record_telemetry: bool = False) -> SimResult:
        """The trace-so-far (bins [0, t)) as a SimResult — the closed-loop
        controller's telemetry feed. Telemetry recording is off by default
        so an active session sees the finished trace exactly once."""
        if self.state.t == 0:
            raise ValueError("no bins simulated yet")
        return _assemble_substep(self.workload, self.fleet, self.disc,
                                 self.policy.name, self.order, self._slos,
                                 self._buf, self.n_substeps,
                                 self.preemptive, t1=self.state.t,
                                 record_telemetry=record_telemetry)


def _dynamics_inputs(workload, fleet: FleetConfig, order, cs_delay):
    """Shared (candidate-independent) array inputs of the compiled backend:
    per-class arrivals, per-(seed, bin, pool) launch-landing offsets, and
    service terms. Launch offsets fold the jitter discretization
    (``clip(rint(delay / dt), 0, scan_bins)``) so the scan step is pure
    arithmetic."""
    pools = fleet.pools
    trace = workload.total_trace()
    S, T = trace.arrivals.shape
    P = len(pools)
    dt = trace.dt_s
    cold_bins, scan_bins, jittered, _, _ = _cold_start_plan(pools, dt)
    jb = np.empty((S, T, P), np.int32)
    for p in range(P):
        if jittered[p] and cs_delay is not None:
            jb[:, :, p] = np.clip(np.rint(cs_delay[:, :, p] / dt).astype(int),
                                  0, scan_bins[p])
        else:
            jb[:, :, p] = cold_bins[p]
    return dict(
        arrivals=workload.arrivals.astype(float), jb=jb, dt=dt,
        order=order,
        t_fixed=[p.service.t_fixed for p in pools],
        t_unit=[p.service.t_per_unit for p in pools],
        max_b=[float(p.service.max_batch) for p in pools],
        tput=[p.service.max_throughput for p in pools],
        max_cold_bins=max(scan_bins))


def _candidate_arrays(fleet: FleetConfig, order, rate0: float):
    """Per-candidate quota bounds and initial fleet for the compiled
    backend (quota dims make these differ across tuning candidates)."""
    pools = fleet.pools
    min_rep = np.array([p.min_replicas for p in pools], float)
    max_rep = np.array([p.max_replicas for p in pools], float)
    init_ready = np.array([_initial_replicas(pc, rate0, p == order[0])
                           for p, pc in enumerate(pools)], float)
    return min_rep, max_rep, init_ready


def _result_from_dynamics(workload, fleet: FleetConfig, disc, policy_name,
                          order, slos, out, n_substeps: int = 1,
                          preemptive: bool = False) -> SimResult:
    """Build a SimResult from one candidate's compiled-dynamics outputs
    (arrays with leading dims (S, T))."""
    S, T, C = out["admitted_c"].shape
    P = fleet.n_pools
    cls = {"admitted": out["admitted_c"], "dropped": out["dropped_c"],
           "queue": out["queue_c"]}
    if n_substeps == 1 and not preemptive:
        rec = {"served": out["slot_served"].sum(axis=2),
               "dropped": out["dropped_c"].sum(axis=2),
               "queue": out["queue_c"].sum(axis=2),
               "replicas": out["pool_rep"].sum(axis=2),
               "billed": out["billed"].sum(axis=2),
               "util": out["util"]}
        return _assemble_result(
            workload, fleet, disc, policy_name, order, slos,
            out["admitted_c"].sum(axis=2), cls, rec, out["pool_rep"],
            out["billed"], out["slot_served"],
            out["slot_split"].reshape(S, T * P, C), out["slot_bt"])
    n = int(n_substeps)
    M = 2 * P
    U = T * n
    rec = {"served": out["served_bin"],
           "dropped": out["dropped_c"].sum(axis=2),
           "queue": out["queue_c"].sum(axis=2),
           "replicas": out["pool_rep"].sum(axis=2),
           "billed": out["billed"].sum(axis=2),
           "util": out["util"]}
    admitted_fine = np.zeros((S, U, C))
    admitted_fine[:, ::n, :] = out["admitted_c"]
    extras = {"preemptions": out["pre_n"], "preempted_work": out["pre_w"],
              "residue_work": out["residue"]}
    return _assemble_result(
        workload, fleet, disc, policy_name, order, slos,
        out["admitted_c"].sum(axis=2), cls, rec, out["pool_rep"],
        out["billed"], out["slot_served"].reshape(S, U, M),
        out["slot_split"].reshape(S, U * M, C),
        out["slot_bt"].reshape(S, U, M),
        n_substeps=n, preemptive=preemptive,
        slot_order=[q for q in order for _ in range(2)],
        admitted_fine=admitted_fine, extras=extras)


def _simulate_fleet_torch(workload, fleet: FleetConfig, policy, disc,
                          max_queue, cs_delay, n_substeps: int = 1,
                          preemptive: bool = False, device=None) -> SimResult:
    """One policy on the compiled backend: a slate of one, through the same
    batched core a tuning round uses."""
    from repro_torch.fleet import torchsim

    kernel, kw = torchsim.slate_arguments(workload, fleet, [policy],
                                          discipline=disc,
                                          max_queue=max_queue,
                                          cs_delay=cs_delay)
    out = torchsim.run_dynamics(kernel, **kw, n_substeps=n_substeps,
                                preemptive=preemptive, device=device)
    return torchsim.slate_results(workload, fleet, [policy], out,
                                  discipline=disc, n_substeps=n_substeps,
                                  preemptive=preemptive)[0]


def simulate(workload, service: ServiceModel, policy, *,
             slo_s: float = None, cold_start_s=30.0,
             max_queue: float = None, initial_replicas: int = None,
             min_replicas: int = 0, max_replicas: int = 1024,
             discipline="fifo", cold_start_seed: int = 0,
             seed_indices=None, backend: str = "numpy",
             n_substeps: int = 1, preemptive: bool = False,
             device=None) -> SimResult:
    """Homogeneous fleet: run ``policy`` against a ``Trace`` or ``Workload``
    on replicas of ``service``. A thin wrapper over ``simulate_fleet`` with
    one pool. ``cold_start_s`` accepts the same constant-or-(mean, jitter)
    spec as ``PoolConfig``; ``n_substeps``/``preemptive`` pick the simulator
    fidelity and ``backend``/``device`` the engine (see ``simulate_fleet``)."""
    # The policy may carry its own shape choice (predictive: recommend()).
    service = getattr(policy, "service", None) or service
    pool = PoolConfig(service=service, cold_start_s=cold_start_s,
                      min_replicas=min_replicas, max_replicas=max_replicas,
                      initial_replicas=initial_replicas)
    return simulate_fleet(workload, FleetConfig((pool,), max_queue=max_queue),
                          policy, slo_s=slo_s, discipline=discipline,
                          cold_start_seed=cold_start_seed,
                          seed_indices=seed_indices, backend=backend,
                          n_substeps=n_substeps, preemptive=preemptive,
                          device=device)
