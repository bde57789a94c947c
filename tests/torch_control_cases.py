"""Scenarios shared by the CPU parity tests of the port's autonomous loop
(``test_torch_drift.py``, ``test_torch_tuning.py``, ``test_torch_oracle.py``,
``test_torch_control.py``), its card tests (``test_torch_gpu.py``) and
``chip_smoke.py``'s phase 12.

Each builder takes ``pkg``, a (core, fleet) pair (the port's by default), and
builds the scenario of a reference test from those modules, so the same scenario
runs through ``repro`` and through the port. ``backend`` picks the simulator;
``dev`` holds the keywords only the port takes (``device``), empty for ``repro``.
"""

import numpy as np

from torch_fleet_cases import PORT, service, v5e


def fleet(pkg, svc, initial=8, cold_start_s=30.0, **pool):
    """One pool of ``svc`` (the reference tests' ``_fleet``; quota 24 unless given)."""
    fm = pkg[1]
    pool.setdefault("max_replicas", 24)
    return fm.FleetConfig(
        (fm.PoolConfig(service=svc, cold_start_s=cold_start_s, initial_replicas=initial, **pool),)
    )


# ---------------- tests/test_tuning.py and tests/test_portfolio.py ----------------


def static_scenario(
    pkg=PORT, backend="numpy", rate_mult=3.0, duration=600.0, n_seeds=8, seed=0, slo_s=2.0, **dev
):
    """``test_tuning.py``'s ``_static_scenario``: StaticPolicy on a steady trace."""
    fm = pkg[1]
    svc = service(pkg)
    tr = fm.poisson_trace(
        rate_mult * svc.max_throughput, duration, dt_s=5.0, n_seeds=n_seeds, seed=seed
    )
    pool = fm.PoolConfig(service=svc, cold_start_s=30.0, initial_replicas=8)
    return fm.TuningScenario(
        name="static-steady",
        workload=tr,
        fleet=fm.FleetConfig((pool,)),
        policy_cls=fm.StaticPolicy,
        context={"slo_s": slo_s},
        backend=backend,
        **dev,
    )


def portfolio_traces(pkg, svc, duration=400.0, n_seeds=4):
    """``test_portfolio.py``'s ``_traces``: steady, flash crowd and ramp-down."""
    fm = pkg[1]
    mt = svc.max_throughput
    return [
        fm.poisson_trace(3.0 * mt, duration, dt_s=5.0, n_seeds=n_seeds, seed=0),
        fm.flash_crowd_trace(2.0 * mt, duration, dt_s=5.0, n_seeds=n_seeds, seed=1, peak_mult=4.0),
        fm.ramp_trace(4.0 * mt, 1.0 * mt, duration, dt_s=5.0, n_seeds=n_seeds, seed=2),
    ]


def portfolio_scenario(pkg=PORT, backend="numpy", robust="worst_case", n_traces=3, **dev):
    """``test_portfolio.py``'s ``_portfolio_scenario``."""
    fm = pkg[1]
    svc = service(pkg)
    pool = fm.PoolConfig(service=svc, cold_start_s=30.0, initial_replicas=8)
    return fm.TuningScenario(
        name="portfolio",
        workload=portfolio_traces(pkg, svc)[:n_traces],
        fleet=fm.FleetConfig((pool,)),
        policy_cls=fm.StaticPolicy,
        context={"slo_s": 2.0},
        robust=robust,
        backend=backend,
        **dev,
    )


def predictive_scenario(pkg=PORT, backend="numpy", **dev):
    """``test_tuning.py``'s ``test_tune_report_builds_runnable_policy`` scenario
    (flash crowd, PredictivePolicy through ``tuning_scenario``), cut to 600 s, on the
    reference's catalog (the port's also lists H100 nodes)."""
    core, fm = pkg
    scn = fm.mset_scenario(n_signals=256, n_memvec=512, fleet=1, slo_s=1.0, shapes=v5e(core))
    svc = scn.service_for(scn.cheapest_shape())
    tr = fm.flash_crowd_trace(
        3.5 * svc.max_throughput,
        600.0,
        dt_s=5.0,
        peak_mult=4.0,
        burst_width_s=60.0,
        n_seeds=8,
        seed=2,
    )
    return fm.tuning_scenario(
        scn, tr, fm.PredictivePolicy, cold_start_s=30.0, backend=backend, **dev
    )


def quota_scenario(pkg=PORT, backend="numpy", **dev):
    """A multi-class workload whose candidates differ in discipline and quota
    (``test_tuning.py``'s cross-cutting dims), so a slate stacks per-candidate
    fleets and tables. Returns (scenario, space)."""
    fm = pkg[1]
    svc = service(pkg)
    wl = fm.tiered_sla_workload(3.0 * svc.max_throughput, 300.0, dt_s=5.0, n_seeds=3, seed=0)
    scen = fm.TuningScenario(
        name="cross-cutting",
        workload=wl,
        fleet=fleet(pkg, svc, max_replicas=16),
        policy_cls=fm.PIPolicy,
        context={"slo_s": 2.0},
        backend=backend,
        **dev,
    )
    space = (
        fm.PIPolicy.param_space()
        + fm.ParamSpace((fm.discipline_dim(),))
        + fm.quota_dims(scen.fleet, lo=4, hi=16)
    )
    return scen, space


# ------------------------------ tests/test_control.py ------------------------------


def control_workload(pkg=PORT, rate_mult=3.0, duration=600.0, n_seeds=3, seed=0, slo_s=2.0):
    """``test_control.py``'s ``_workload``: (workload, service)."""
    fm = pkg[1]
    svc = service(pkg)
    tr = fm.poisson_trace(
        rate_mult * svc.max_throughput, duration, dt_s=5.0, n_seeds=n_seeds, seed=seed
    )
    return fm.Workload.from_trace(tr, slo_s), svc


def tuned_static(pkg=PORT, backend="numpy", workload=None, svc=None, **dev):
    """``test_control.py``'s ``_tuned_static``: (scenario, space, incumbent)."""
    fm = pkg[1]
    if workload is None:
        workload, svc = control_workload(pkg)
    ts = fm.TuningScenario(
        name="warm-seed",
        workload=workload,
        fleet=fleet(pkg, svc),
        policy_cls=fm.StaticPolicy,
        context={"slo_s": 2.0},
        backend=backend,
        **dev,
    )
    space = fm.ParamSpace((fm.Integer("n_replicas", 1, 24, log=True),))
    report = fm.tune(
        ts, space, fm.Objective(0.95, 2000.0), fm.TuningBudget(n_candidates=5, init_seeds=1), seed=0
    )
    return ts, space, report


def controller(pkg=PORT, backend="numpy", **dev):
    """``test_control.py``'s ``_controller``: (controller, live workload, scenario)."""
    fm = pkg[1]
    wl, svc = control_workload(pkg, duration=600.0)
    ts, _, report = tuned_static(pkg, backend, workload=wl, svc=svc, **dev)
    ctl = fm.ClosedLoopController(
        ts,
        report,
        segment_bins=15,
        retune_budget=fm.TuningBudget(n_candidates=6, init_seeds=1),
        objective=fm.Objective(0.95, 2000.0),
    )
    return ctl, wl, ts


def drift_case(pkg=PORT, backend="numpy", **dev):
    """``test_control.py``'s factor-3 drift at bin 60: (controller, case)."""
    fm = pkg[1]
    ctl, wl, _ = controller(pkg, backend, **dev)
    return ctl, fm.service_degradation_case(wl, fleet(pkg, service(pkg)), factor=3.0, t_drift=60)


# ------------------------------ tests/test_oracle.py -------------------------------

# (lowest and highest rate in max throughputs, burstiness axis, candidates) of the
# closed-loop tables of test_oracle.py: a hull the inflated query lands in, one it
# misses, and the bare-table case's
HIT_GRID = (1.5, 8.0, (1.0, 1.6), 5)
MISS_GRID = (0.1, 0.2, (1.0, 1.1), 3)
BARE_GRID = (1.5, 8.0, (1.0, 1.6), 3)


def oracle_drift_setup(pkg=PORT, backend="numpy", **dev):
    """``test_oracle.py``'s ``_drift_setup``: (svc, fleet, case, scenario, incumbent)."""
    fm = pkg[1]
    svc = service(pkg)
    fl = fleet(pkg, svc)
    tr = fm.poisson_trace(2.5 * svc.max_throughput, 600.0, dt_s=5.0, n_seeds=2, seed=0)
    wl = fm.Workload.from_trace(tr, 2.0)
    case = fm.service_degradation_case(wl, fl, factor=1.6, t_drift_frac=0.4)
    scen = fm.TuningScenario(
        name="cl",
        workload=wl,
        fleet=fl,
        policy_cls=fm.PIPolicy,
        context={"slo_s": 2.0},
        backend=backend,
        **dev,
    )
    incumbent = fm.tune(
        scen,
        fm.PIPolicy.param_space(),
        fm.Objective(min_attainment=0.9),
        fm.TuningBudget(n_candidates=4, init_seeds=1),
        seed=0,
    )
    return svc, fl, case, scen, incumbent


def oracle_table(pkg, svc, fl, spec, backend="numpy", **dev):
    """One of ``test_oracle.py``'s closed-loop tables (``HIT_GRID``, ...)."""
    fm = pkg[1]
    lo, hi, burst, candidates = spec
    mt = svc.max_throughput
    grid = fm.OracleGrid(
        mean_rates=(lo * mt, hi * mt),
        burstiness=burst,
        slos=(1.0, 4.0),
        duration_s=400.0,
        dt_s=5.0,
        n_seeds=2,
        seed=3,
    )
    return fm.build_oracle(
        grid,
        fl,
        fm.PIPolicy,
        fm.PIPolicy.param_space(),
        objective=fm.Objective(min_attainment=0.9),
        budget=fm.TuningBudget(n_candidates=candidates, init_seeds=1),
        backend=backend,
        **dev,
    )


def small_oracle_grid(pkg, svc):
    """``test_oracle.py``'s ``small_oracle`` grid: 2 x 2 x 2 cells."""
    mt = svc.max_throughput
    return pkg[1].OracleGrid(
        mean_rates=(2.0 * mt, 4.0 * mt),
        burstiness=(1.0, 1.8),
        slos=(1.0, 3.0),
        duration_s=400.0,
        dt_s=5.0,
        n_seeds=2,
        seed=3,
    )


# ----------------------------- tests/test_telemetry.py -----------------------------


def drift_world(pkg=PORT):
    """``test_telemetry.py``'s ``drift_setup`` world: (fleet, run_trace(seed, fl))."""
    fm = pkg[1]
    svc = service(pkg)
    fl = fm.FleetConfig((fm.PoolConfig(svc, cold_start_s=30.0),))

    def run_trace(seed, fl=fl):
        tr = fm.diurnal_trace(2.0 * svc.max_throughput, 3600.0, dt_s=10.0, n_seeds=6, seed=seed)
        return fm.simulate_fleet(tr, fl, fm.QueueProportionalPolicy(), slo_s=2.0)

    return fl, run_trace


def drift_windows(pkg=PORT):
    """``test_telemetry.py``'s three observation windows: a fresh seed 7, the same
    seed on a fleet degraded x1.3, and seed 11 as a raw matrix."""
    fm = pkg[1]
    fl, run = drift_world(pkg)
    drift = fm.telemetry.drift
    return {
        "fresh-7": run(7),
        "degraded-1.3": run(7, fl=drift.degrade_fleet(fl, 1.3)),
        "raw-11": drift.telemetry_matrix(run(11)),
    }


# ------------------------------------- the bars -------------------------------------


def events_of(res):
    """A controller run's event sequence, as (kind, bin) pairs."""
    return [(e.kind, e.t_bin) for e in res.events]


def decision_record(res):
    """What a controller run decided, beyond its event sequence: the estimate, the
    active params, each event's record (but the measured oracle latency) and each
    re-tune's winner, spend and per-seed scores."""
    return dict(
        est_factor=res.est_factor,
        active=res.active_params,
        n_alarms=res.n_alarms,
        n_swaps=res.n_swaps,
        oracle_hits=res.oracle_hits,
        oracle_misses=res.oracle_misses,
        details=[
            (e.kind, e.t_bin, {k: v for k, v in e.detail.items() if k != "latency_us"})
            for e in res.events
        ],
        retunes=[
            (r.winner.params, r.sims_used, r.baseline.score.tolist(), r.winner.score.tolist())
            for r in res.retunes
        ],
    )


def eval_arrays(ev):
    """A CandidateEval's per-seed arrays (and its portfolio members')."""
    keys = ("cost_usd_hr", "attainment", "drop_rate", "score")
    out = {k: np.asarray(getattr(ev, k)) for k in keys}
    for i, m in enumerate(ev.per_trace or ()):
        out.update({f"{k}[{i}]": v for k, v in eval_arrays(m).items()})
    return out


def same_evals(a, b):
    """Whether two lists of CandidateEvals have the same params and per-seed arrays,
    bit for bit."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        ax, ay = eval_arrays(x), eval_arrays(y)
        if x.params != y.params or ax.keys() != ay.keys():
            return False
        if not all(np.array_equal(ax[k], ay[k]) for k in ax):
            return False
    return True
