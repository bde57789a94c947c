"""Scenarios and bars shared by the fleet backend's CPU tests
(``test_torch_fleet_backend.py``), its card tests (``test_torch_gpu.py``) and the
numpy-path tests against the JAX package (``test_torch_fleet.py``).

Every scenario is built from the modules it is handed (``pkg``, a (core, fleet)
pair: the port's by default), so the card tests need no JAX while
``test_torch_fleet.py`` builds the same scenario from both packages. Each golden
scenario is a function of the simulator's keyword arguments: called bare it runs
the numpy engine, called with ``backend="torch"`` and a ``device`` the compiled
one.
"""

import numpy as np
import torch

import repro_torch.core as t_core
import repro_torch.fleet as t_fleet
from repro_torch.fleet import kernels, torchsim

PORT = (t_core, t_fleet)


def v5e(core):
    """The reference's catalog: the port's also lists H100 nodes."""
    return [s for s in core.CATALOG if s.name.startswith("v5e")]


DISCIPLINES = ("fifo", "priority", "edf")
SUBSTEP_GRID = [(1, True), (2, False), (2, True), (4, True)]

# bin-by-bin SimResult fields both backends must agree on (test_jax_backend.py)
TRACE_FIELDS = (
    "served", "queue", "billed_replicas", "latency_s", "ok_served", "utilization", "dropped",
    "admitted", "replicas", "pool_billed", "pool_served", "pool_replicas", "class_ok",
    "class_queue", "class_served", "class_admitted", "class_dropped",
)

# every per-(seed, bin) array on SimResult: the bit-exactness surface (test_substep.py)
FIELDS = (
    "arrivals", "admitted", "served", "dropped", "queue", "replicas", "billed_replicas",
    "latency_s", "ok_served", "pool_replicas", "pool_served", "pool_billed", "utilization",
    "class_admitted", "class_served", "class_dropped", "class_queue", "class_ok",
)


def coarse_gap(a, b):
    """The bar of ``tests/test_jax_backend.py``'s ``_assert_equivalent`` (a the
    reference, b the result under test): every element of ``TRACE_FIELDS`` within
    1e-8 + 1e-9|b|, the p50/p90/p99 sojourns within 1e-9, the sojourn mass within
    1e-6 relative. Returns (max |a - b|, the largest quantile delta, whether the bar
    holds)."""
    err, ok = 0.0, True
    for f in TRACE_FIELDS:
        x, y = np.asarray(getattr(a, f), float), np.asarray(getattr(b, f), float)
        d = np.abs(x - y)
        err = max(err, float(d.max(initial=0.0)))
        ok &= bool((d <= 1e-8 + 1e-9 * np.abs(y)).all())
    q_err = max(
        abs(
            t_fleet.weighted_percentile(a.sojourn_values, a.sojourn_weights, q)
            - t_fleet.weighted_percentile(b.sojourn_values, b.sojourn_weights, q)
        )
        for q in (50, 90, 99)
    )
    wa, wb = a.sojourn_weights.sum(), b.sojourn_weights.sum()
    ok &= q_err <= 1e-9 and abs(wa - wb) <= max(1e-6 * abs(wb), 1e-12)
    ok &= a.discipline == b.discipline and a.policy_name == b.policy_name
    return err, q_err, bool(ok)


def bit_gap(a, b):
    """``tests/test_substep.py``'s bit-exactness surface: ``FIELDS``, the sojourn
    distribution and the substep extras. Returns (whether all are identical, the
    largest |a - b| among them)."""
    extras = ("preemptions", "preempted_work", "residue_work")
    pairs = [(getattr(a, f), getattr(b, f)) for f in FIELDS + extras]
    pairs += [(a.sojourn_values, b.sojourn_values), (a.sojourn_weights, b.sojourn_weights)]
    same, err = True, 0.0
    for x, y in pairs:
        if x is None or y is None:
            same &= x is None and y is None
            continue
        x, y = np.asarray(x, float), np.asarray(y, float)
        same &= x.shape == y.shape and bool(np.array_equal(x, y))
        if x.shape == y.shape:
            err = max(err, float(np.abs(x - y).max(initial=0.0)))
    return bool(same), err


def assert_equivalent(a, b):
    err, q_err, ok = coarse_gap(a, b)
    assert ok, f"coarse bar missed: max |a - b| {err:.3e}, sojourn quantiles {q_err:.3e}"


def assert_bitexact(a, b, label=""):
    same, err = bit_gap(a, b)
    assert same, f"{label}: not bit-exact (max |a - b| {err:.3e})"


def service(pkg=PORT):
    core, fm = pkg
    cell = core.CellResult(
        params={"batch": 64, "chips": 4},
        shape_name="v5e-4",
        terms=core.RooflineTerms(0.4, 0.1, 0.05),
        analysis={"peak_memory_per_device": 1e9},
    )
    return fm.service_model_from_cell(cell, units_per_step=64)


def _scenario(pkg, n_signals=256, n_memvec=512, fleet=1):
    core, fm = pkg
    return fm.mset_scenario(
        n_signals=n_signals, n_memvec=n_memvec, fleet=fleet, slo_s=1.0, shapes=v5e(core)
    )


# -------- the golden scenarios of test_jax_backend.py:62-121, cut to 180 bins --------
# Each takes ``pkg``, the (core, fleet) modules to build from (the port's by default;
# tests/test_torch_fleet.py passes the JAX package's), and the simulator's keywords.


def flash_crowd_queue_prop(pkg=PORT, **kw):
    fm = pkg[1]
    svc = service(pkg)
    tr = fm.flash_crowd_trace(5 * svc.max_throughput, 900.0, dt_s=5.0, n_seeds=4, seed=0)
    return fm.simulate(tr, svc, fm.QueueProportionalPolicy(), slo_s=2.0, cold_start_s=60.0, **kw)


def tiered_sla(disc):
    def run(pkg=PORT, **kw):
        fm, scn = pkg[1], _scenario(pkg)
        svc = scn.service_for(scn.cheapest_shape())
        wl = fm.tiered_sla_workload(3.0 * svc.max_throughput, 900.0, dt_s=5.0, n_seeds=3, seed=0)
        return fm.simulate(wl, svc, fm.StaticPolicy(8), cold_start_s=30.0, discipline=disc, **kw)

    return run


def hetero_jittered(pkg=PORT, **kw):
    fm, scn = pkg[1], _scenario(pkg)
    svc = scn.service_for(scn.cheapest_shape())
    fleet = scn.fleet_for(["v5e-4", "v5e-16"], cold_start_s=(45.0, 0.5), max_replicas=16)
    wl = fm.interactive_batch_workload(
        4.0 * svc.max_throughput, 900.0, dt_s=5.0, n_seeds=3, seed=1
    )
    pol = fm.HeterogeneousPredictivePolicy(scn.rows, scn.constraint(), scn.units_per_step, fleet)
    return fm.simulate_fleet(wl, fleet, pol, discipline="edf", cold_start_seed=3, **kw)


def predictive_admission(pkg=PORT, **kw):
    fm, scn = pkg[1], _scenario(pkg)
    svc = scn.service_for(scn.cheapest_shape())
    tr = fm.flash_crowd_trace(
        3.5 * svc.max_throughput, 900.0, dt_s=5.0, peak_mult=4.0, n_seeds=3, seed=2
    )
    pol = fm.PredictivePolicy(scn.rows, scn.constraint(), scn.units_per_step, horizon_s=120.0)
    return fm.simulate(tr, svc, pol, slo_s=1.0, cold_start_s=60.0, max_queue=4000.0, **kw)


def predictive_one_seed(pkg=PORT, **kw):
    """One seed, so numpy sums each forecast window pairwise (20 bins: two blocks of
    eight lanes and a rest of four)."""
    fm, scn = pkg[1], _scenario(pkg)
    svc = scn.service_for(scn.cheapest_shape())
    tr = fm.flash_crowd_trace(
        3.5 * svc.max_throughput, 900.0, dt_s=5.0, peak_mult=4.0, n_seeds=1, seed=5
    )
    pol = fm.PredictivePolicy(
        scn.rows, scn.constraint(), scn.units_per_step, horizon_s=120.0, window_bins=20
    )
    return fm.simulate(tr, svc, pol, slo_s=1.0, cold_start_s=60.0, **kw)


def hetero_one_seed(pkg=PORT, **kw):
    """One seed on two pools, with a 160-bin sustain window: past bin 128 numpy
    splits its pairwise sum in two halves."""
    fm, scn = pkg[1], _scenario(pkg, 1024, 4096, fleet=8)
    svc = scn.service_for("v5e-4")
    fleet = scn.fleet_for(["v5e-4", "v5e-16"], cold_start_s=45.0, max_replicas=12)
    tr = fm.flash_crowd_trace(4.0 * svc.max_throughput, 900.0, dt_s=5.0, n_seeds=1, seed=6)
    pol = fm.HeterogeneousPredictivePolicy(
        scn.rows, scn.constraint(), scn.units_per_step, fleet, window_bins=12,
        sustain_bins=160,
    )
    return fm.simulate_fleet(tr, fleet, pol, slo_s=1.0, **kw)


GOLDEN = {
    "flash-crowd-queue-prop": flash_crowd_queue_prop,
    **{f"tiered-sla-{d}": tiered_sla(d) for d in DISCIPLINES},
    "hetero-jittered-edf": hetero_jittered,
    "predictive-admission": predictive_admission,
    "predictive-one-seed": predictive_one_seed,
    "hetero-one-seed": hetero_one_seed,
}


def substep_run(disc, n_substeps, preemptive, pkg=PORT, **kw):
    """``tests/test_substep.py``'s ``_run``: batches span substeps."""
    core, fm = pkg
    svc = fm.ServiceModel("svc", core.get_shape("v5e-4"), 3.0, 0.2, 8)
    fleet = fm.FleetConfig(
        (fm.PoolConfig(svc, cold_start_s=2.0, min_replicas=1, max_replicas=4,
                       initial_replicas=2),)
    )
    wl = fm.interactive_batch_workload(3.0, 60.0, dt_s=2.0, n_seeds=3, seed=7)
    pol = fm.ReactivePolicy(upper=0.7, lower=0.3, cooldown_s=4.0)
    return fm.simulate_fleet(
        wl, fleet, pol, discipline=disc, n_substeps=n_substeps, preemptive=preemptive, **kw
    )


def fidelity_run(duration_s=180.0, n_seeds=2, pkg=PORT, **kw):
    """``benchmarks/sim_perf.py``'s fidelity workload and service under
    preemptive EDF on 3 static replicas (there 600 s and 4 seeds)."""
    core, fm = pkg
    svc = fm.ServiceModel("fidelity", core.get_shape("v5e-4"), 0.5, 0.0125, 16)
    wl = fm.tiered_sla_workload(60.0, duration_s, dt_s=2.0, n_seeds=n_seeds, seed=3)
    return fm.simulate(
        wl, svc, fm.StaticPolicy(3), discipline="edf", initial_replicas=3, n_substeps=4,
        preemptive=True, **kw,
    )


# ------------------------ the policy families, step by step -----------------------


def families(pkg=PORT):
    """Every kernel family (PI under both signals) on a one- or two-pool fleet,
    with three tiered classes. Returns ({name: (fleet, make_policy)}, classes)."""
    fm, scn = pkg[1], _scenario(pkg, 1024, 4096, fleet=8)
    classes = (
        fm.RequestClass("gold", 1.0, priority=0),
        fm.RequestClass("silver", 4.0, priority=1),
        fm.RequestClass("bronze", 60.0, priority=2),
    )
    one = scn.fleet_for(["v5e-4"], cold_start_s=60.0, max_replicas=16)
    two = scn.fleet_for(["v5e-4", "v5e-16"], cold_start_s=(45.0, 0.3), max_replicas=12)
    rows, con, ups = scn.rows, scn.constraint(), scn.units_per_step
    return {
        "static": (one, lambda: fm.StaticPolicy(7)),
        "reactive": (one, lambda: fm.ReactivePolicy(upper=0.7, lower=0.3, cooldown_s=15.0)),
        "queue-prop": (one, lambda: fm.QueueProportionalPolicy(drain_s=20.0, headroom=0.8)),
        "predictive": (one, lambda: fm.PredictivePolicy(rows, con, ups, horizon_s=90.0,
                                                        window_bins=12)),
        "hetero-predictive": (two, lambda: fm.HeterogeneousPredictivePolicy(
            rows, con, ups, two, horizon_s=90.0, window_bins=9, sustain_bins=20)),
        "pi": (one, lambda: fm.PIPolicy(4, kp=6.0, ki=0.7, setpoint=0.6)),
        "pi-queue": (one, lambda: fm.PIPolicy(4, kp=3.0, ki=0.2, setpoint=0.5, signal="queue")),
        "pid": (one, lambda: fm.PIDPolicy(4, kp=6.0, ki=0.7, kd=2.5, setpoint=0.6, windup=5.0)),
        "fit-to-usage": (one, lambda: fm.FitToUsagePolicy(headroom=0.35, window_bins=5)),
    }, classes


FAMILIES = ("static", "reactive", "queue-prop", "predictive", "hetero-predictive", "pi",
            "pi-queue", "pid", "fit-to-usage")


def observations(fleet, classes, S=3, T=60, dt=5.0, seed=11):
    """Random per-bin observations of ``fleet`` (a trend with noise, some empty
    queues, utilization clipped at both ends), as dicts of numpy arrays."""
    C, P = len(classes), fleet.n_pools
    rng = np.random.default_rng(seed)
    trend = 40.0 + 25.0 * np.sin(np.arange(T) / 7.0)
    for t in range(T):
        crate = np.maximum(trend[t] * np.array([0.2, 0.3, 0.5]) + rng.normal(0, 3, (S, C)), 0)
        cq = np.where(rng.random((S, C)) < 0.3, 0.0, rng.exponential(30.0, (S, C)))
        ready = rng.integers(0, 9, (S, P)).astype(float)
        flight = rng.integers(0, 3, (S, P)).astype(float)
        util = np.clip(rng.uniform(-0.2, 1.2, S), 0.0, 1.0)
        yield dict(
            t_s=(t + 1) * dt, dt_s=dt, arrival_rate=crate.sum(axis=1), queue=cq.sum(axis=1),
            replicas=ready.sum(axis=1), in_flight=flight.sum(axis=1), utilization=util,
            pool_replicas=ready, pool_in_flight=flight, class_queue=cq,
            class_arrival_rate=crate,
        )


def fleet_obs(fm, fleet, classes, o):
    """``o`` (from :func:`observations`) as the ``FleetObs`` of the package ``fm``."""
    return fm.FleetObs(
        service=fleet.pools[0].service, pools=fleet.pools, classes=classes, **o
    )


def check_kernel_steps(family, device, S=3, T=60, dt=5.0):
    """Step ``family``'s kernel bin by bin on ``device`` against its numpy
    policy, on random observations both sides share; the targets must be
    identical. The kernel's ring is wider than the policy's own window, as a
    slate with wider candidates builds it."""
    fams, classes = families()
    fleet, make = fams[family]
    pol = make()
    kernel = t_fleet.make_kernel(pol, fleet, classes, max_window=30, max_sustain=40)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64)[None], device=device)

    kp = {k: dev([v]) for k, v in kernel.params_of(pol).items()}
    pol.reset(S)
    state = kernel.init(1, S, device)
    lo = dev([[p.min_replicas for p in fleet.pools]])
    hi = dev([[p.max_replicas for p in fleet.pools]])
    for t, o in enumerate(observations(fleet, classes, S, T, dt)):
        want = np.asarray(pol.decide(t, fleet_obs(t_fleet, fleet, classes, o)), float)
        kobs = kernels.KernelObs(
            t_s=o["t_s"], dt_s=dt, min_replicas=lo, max_replicas=hi,
            **{k: dev(v) for k, v in o.items() if k not in ("t_s", "dt_s")},
        )
        state, got = kernel.step(kp, state, kobs)
        assert got.shape == (1, S, fleet.n_pools)
        assert np.array_equal(got[0].cpu().numpy(), want.reshape(S, -1)), f"{family}: bin {t}"


# ------------------------------------ the lattice ---------------------------------


def flash_slate(n=5, n_seeds=3, duration=600.0, pkg=PORT):
    """``benchmarks/tune_controller.py``'s flash-crowd predictive-tuning
    scenario, cut to ``duration`` and ``n_seeds``, with ``n`` LHS candidates.
    Returns (workload, fleet, candidate params, policy context)."""
    core, fm = pkg
    scn = _scenario(pkg, 1024, 4096, fleet=8)
    svc = scn.service_for(scn.cheapest_shape())
    tr = fm.flash_crowd_trace(
        3.5 * svc.max_throughput, duration, dt_s=5.0, peak_mult=4.0,
        burst_width_s=duration / 30, n_seeds=n_seeds, seed=2,
    )
    shape = core.recommend(scn.rows_at(), scn.constraint()).shape.name
    fleet = fm.FleetConfig((scn.pool_for(shape, cold_start_s=60.0, max_replicas=16),))
    rows = [r for r in scn.rows if r.shape_name == shape]
    ctx = dict(rows=rows, constraint=scn.constraint(), units_per_step=scn.units_per_step)
    params = fm.PredictivePolicy.param_space().sample_lhs(n, seed=0)
    return fm.Workload.from_trace(tr, scn.slo_s), fleet, params, ctx


def check_lattice(device):
    """One batched dispatch equals each candidate's own ``simulate_fleet`` on
    the compiled backend, bit for bit, and the numpy engine at the coarse bar;
    tiles equal the untiled dispatch; padding rows are dropped."""
    wl, fleet, params, ctx = flash_slate()
    pols = [t_fleet.PredictivePolicy.from_params(p, **ctx) for p in params]
    kernel, kw = torchsim.slate_arguments(wl, fleet, pols)
    out = torchsim.run_dynamics(kernel, **kw, device=device)
    tiled = torchsim.run_dynamics(kernel, **kw, tile=2, device=device)
    for k, v in out.items():
        assert v.shape[:3] == (5, 3, wl.n_bins)
        assert np.array_equal(v, tiled[k]), k
    sims = torchsim.slate_results(wl, fleet, pols, out)
    for p, sim in zip(params, sims):
        pol = t_fleet.PredictivePolicy.from_params(p, **ctx)
        own = t_fleet.simulate_fleet(wl, fleet, pol, backend="torch", device=device)
        assert_bitexact(sim, own, str(p))
        assert_equivalent(t_fleet.simulate_fleet(wl, fleet, pol), sim)


def replay_slates(pkg=PORT):
    """Two slates of one dispatch signature that differ in every tensor input the
    scenario can vary: the knobs (the windows permuted, so the ring stays as wide),
    the arrivals (another trace seed and peak) and the cold-start jitter (another
    jitter seed). Yields (workload, fleet, policies, cold_start_seed) for each."""
    core, fm = pkg
    scn = _scenario(pkg, 1024, 4096, fleet=8)
    svc = scn.service_for(scn.cheapest_shape())
    shape = core.recommend(scn.rows_at(), scn.constraint()).shape.name
    pool = scn.pool_for(shape, cold_start_s=(60.0, 0.5), max_replicas=16)
    fleet = fm.FleetConfig((pool,))
    rows = [r for r in scn.rows if r.shape_name == shape]
    ctx = dict(rows=rows, constraint=scn.constraint(), units_per_step=scn.units_per_step)
    base = fm.PredictivePolicy.param_space().sample_lhs(4, seed=0)
    other = [
        dict(
            p,
            window_bins=q["window_bins"],
            horizon_s=1.7 * p["horizon_s"],
            headroom=1.53 - p["headroom"],
        )
        for p, q in zip(base, base[::-1])
    ]
    for seed, params in enumerate((base, other)):
        tr = fm.flash_crowd_trace(
            3.5 * svc.max_throughput,
            300.0,
            dt_s=5.0,
            peak_mult=4.0 + seed,
            burst_width_s=10.0,
            n_seeds=3,
            seed=2 + seed,
        )
        pols = [fm.PredictivePolicy.from_params(p, **ctx) for p in params]
        yield fm.Workload.from_trace(tr, scn.slo_s), fleet, pols, seed


def check_replay(device):
    """The slates of :func:`replay_slates`, then the first again: one signature,
    so the first dispatch is cold and the others warm. On a card the first runs
    eagerly, the second captures a CUDA graph over its own inputs and the third
    replays that graph on the first slate's. Each equals numpy's runs of its own
    policies at the coarse bar."""
    held = torchsim.clear_compiled()  # so that the first dispatch is cold
    slates = list(replay_slates())
    with t_fleet.telemetry.session() as tel:
        for wl, fleet, pols, seed in slates + slates[:1]:
            kernel, kw = torchsim.slate_arguments(wl, fleet, pols, cold_start_seed=seed)
            out = torchsim.run_dynamics(kernel, **kw, device=device)
            for pol, sim in zip(pols, torchsim.slate_results(wl, fleet, pols, out)):
                ref = t_fleet.simulate_fleet(wl, fleet, pol, cold_start_seed=seed)
                assert_equivalent(ref, sim)
    spans = [s.attrs for s in tel.tracer.roots if s.name == "torchsim.dispatch"]
    assert [a["kind"] for a in spans] == ["cold", "warm", "warm"], spans
    paths = ["eager", "capture", "replay"] if device.type == "cuda" else ["eager"] * 3
    assert [a["path"] for a in spans] == paths, spans
    del held


def check_forecaster(device, T=170, dt=5.0):
    """The kernels' masked-ring forecast and rolling mean against
    ``autoscaler._RateForecaster``, value for value, with three seeds (numpy
    adds a window's rows left to right) and with one (numpy sums the column
    pairwise, halving it past 128 bins): a one-ulp difference here is what flips
    a policy's ``ceil()`` further on."""
    from repro_torch.fleet.autoscaler import _RateForecaster

    W = 160
    age = kernels._ages(W, device)
    for S in (3, 1):
        rng = np.random.default_rng(3)
        rates = np.abs(50.0 + np.cumsum(rng.normal(0, 4, (T, S)), axis=0))
        rates *= rng.uniform(0.9, 1.1)
        for window, horizon in ((3, 10.0), (12, 120.0), (17, 45.0), (48, 600.0), (160, 60.0)):
            ref = _RateForecaster(window, horizon)
            ref.reset(S)
            hist = torch.zeros((W, 1, S), dtype=torch.float64, device=device)
            wb = torch.full((1, 1), float(ref.window_bins), dtype=torch.float64, device=device)
            h = torch.full((1, 1), horizon, dtype=torch.float64, device=device)
            for t in range(T):
                r = torch.as_tensor(rates[t][None], device=device)
                hist = kernels._push(hist, r)
                want = ref.observe(type("Obs", (), {"arrival_rate": rates[t], "dt_s": dt}))
                got = kernels._forecast(hist, age, t + 1, wb, h, dt)
                assert np.array_equal(got[0].cpu().numpy(), want), (S, window, t)
                mean = kernels._mean_rate(hist, age, t + 1, wb)
                assert np.array_equal(mean[0].cpu().numpy(), ref.mean_rate()), (S, window, t)
