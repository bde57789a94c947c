"""The port's fleet layer on its numpy path, held against the JAX package's.

``repro_torch.fleet`` carries ``repro.fleet``'s numpy modules across (traces,
workloads, the cohort model, the disciplines, the policies, the coarse and
substep simulators, reports, scenarios, telemetry). Both packages build their
objects from the same arguments, and every result must be identical: each
``SimResult`` array compares with ``np.array_equal``, and rendered tables compare
as strings.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as r_core
import repro.fleet as r_fleet
import repro_torch.core as t_core
import repro_torch.fleet as t_fleet
from repro.core import report as r_report
from repro.fleet import simulator as r_sim
from repro_torch.core import report as t_report
from repro_torch.fleet import simulator as t_sim
from torch_fleet_cases import (
    FAMILIES,
    GOLDEN,
    families,
    fidelity_run,
    fleet_obs,
    flash_slate,
    observations,
)

PKGS = ((r_core, r_fleet), (t_core, t_fleet))
DISCIPLINES = ("fifo", "priority", "edf")


def both(build):
    """``build(core, fleet)`` once with each package's modules."""
    return [build(core, fleet) for core, fleet in PKGS]


def v5e(core):
    """The reference's catalog: the port's also lists H100 nodes."""
    return [s for s in core.CATALOG if s.name.startswith("v5e")]


def _cell(core, shape="v5e-4", t_comp=0.4, t_mem=0.1, t_coll=0.05, batch=64):
    return core.CellResult(
        params={"batch": batch, "chips": core.get_shape(shape).chips},
        shape_name=shape,
        terms=core.RooflineTerms(t_comp, t_mem, t_coll),
        analysis={"peak_memory_per_device": 1e9},
    )


def _service(core, fleet, **kw):
    return fleet.service_model_from_cell(_cell(core, **kw), units_per_step=kw.get("batch", 64))


def assert_same_sim(a, b):
    """Every field of two ``SimResult``s identical (structure by name)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("fleet", "workload"):
            continue
        if f.name == "trace":
            assert np.array_equal(x.arrivals, y.arrivals) and np.array_equal(x.rate, y.rate)
            assert (x.name, x.dt_s) == (y.name, y.dt_s)
        elif f.name == "class_sojourns":
            assert len(x) == len(y)
            for (v1, w1), (v2, w2) in zip(x, y):
                assert np.array_equal(v1, v2) and np.array_equal(w1, w2)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.shape == y.shape and np.array_equal(x, y), f"field {f.name!r} differs"
        else:
            assert x == y, f"field {f.name!r} differs"
    assert a.fleet.shape_label() == b.fleet.shape_label()
    assert a.billed_usd() == b.billed_usd() and a.replica_bins() == b.replica_bins()


# ------------------------------ traces, services ------------------------------


@pytest.mark.parametrize(
    "name,kw",
    [
        ("poisson_trace", dict(rate_per_s=20.0, duration_s=300.0, dt_s=5.0)),
        ("diurnal_trace", dict(mean_rate_per_s=20.0, duration_s=600.0, dt_s=5.0)),
        ("flash_crowd_trace", dict(base_rate_per_s=20.0, duration_s=600.0, dt_s=5.0)),
        ("ramp_trace", dict(rate0_per_s=5.0, rate1_per_s=40.0, duration_s=300.0, dt_s=5.0)),
    ],
)
def test_traces_equal_under_the_same_seed(name, kw):
    for seed in (0, 7):
        a, b = both(lambda core, fleet: getattr(fleet, name)(n_seeds=3, seed=seed, **kw))
        assert (a.name, a.dt_s) == (b.name, b.dt_s)
        assert np.array_equal(a.rate, b.rate) and np.array_equal(a.arrivals, b.arrivals)


def test_replay_resample_standard_and_csv_traces(tmp_path):
    rates = np.abs(np.sin(np.arange(40) / 5.0)) * 30.0
    a, b = both(lambda core, fleet: fleet.replay_trace(rates, dt_s=2.0, n_seeds=2, seed=4))
    assert np.array_equal(a.arrivals, b.arrivals)
    ra, rb = both(lambda core, fleet: fleet.resample_trace(
        fleet.replay_trace(rates, dt_s=2.0, n_seeds=2, seed=4), 1.0, seed=1))
    assert np.array_equal(ra.arrivals, rb.arrivals) and np.array_equal(ra.rate, rb.rate)
    sa, sb = both(lambda core, fleet: fleet.standard_traces(10.0, 600.0, dt_s=5.0, n_seeds=2))
    assert [t.name for t in sa] == [t.name for t in sb]
    for x, y in zip(sa, sb):
        assert np.array_equal(x.arrivals, y.arrivals)
    path = tmp_path / "trace.csv"
    path.write_text("t,rate\n" + "".join(f"{i},{r:.3f}\n" for i, r in enumerate(rates)))
    ca, cb = both(lambda core, fleet: fleet.load_trace_csv(path, dt_s=60.0, n_seeds=2))
    assert np.array_equal(ca.rate, cb.rate) and np.array_equal(ca.arrivals, cb.arrivals)


def test_service_model_from_cell():
    for kw in (dict(), dict(shape="v5e-16", t_comp=8.0, t_mem=2.0), dict(batch=8)):
        a, b = both(lambda core, fleet: _service(core, fleet, **kw))
        for k in ("name", "t_fixed", "t_per_unit", "max_batch"):
            assert getattr(a, k) == getattr(b, k)
        assert a.max_throughput == b.max_throughput
        assert a.usd_per_request == b.usd_per_request
        assert a.batch_time(5) == b.batch_time(5)


# ---------------------------- cohorts, disciplines ----------------------------


def _classes(fleet, slos=(1.5, 4.0, 30.0)):
    return tuple(fleet.RequestClass(f"c{i}", s, priority=i) for i, s in enumerate(slos))


@pytest.mark.parametrize("disc", DISCIPLINES)
def test_split_service_and_cohort_metrics(disc):
    rng = np.random.default_rng(5)
    S, T, C, K = 3, 12, 3, 24
    admitted = rng.integers(0, 5, (S, T, C)).astype(float)
    capacity = rng.integers(0, 7, (S, K)).astype(float)
    slot_bin = np.repeat(np.arange(T), K // T)
    a, b = both(lambda core, fleet: fleet.split_service(
        disc, _classes(fleet), admitted, capacity, slot_bin, dt_s=1.0))
    assert np.array_equal(a, b)
    slos = np.array([1.5, 4.0, 30.0])
    slot_bt = rng.uniform(0.1, 2.0, (S, K))
    ma, mb = both(lambda core, fleet: fleet.multiclass_cohort_metrics(
        admitted, a, slot_bin, slot_bt, 1.0, slos))
    for x, y in zip(ma, mb):
        for k in ("ok_served", "mean_sojourn", "sojourn_values", "sojourn_weights"):
            assert np.array_equal(getattr(x, k), getattr(y, k))
    ca, cb = both(lambda core, fleet: fleet.cohort_metrics(
        admitted[..., 0], a[..., 0], slot_bin, slot_bt, 1.0, 2.5))
    for k in ("ok_served", "mean_sojourn", "sojourn_values", "sojourn_weights"):
        assert np.array_equal(getattr(ca, k), getattr(cb, k))
    ta, tb = both(lambda core, fleet: fleet.cohort_tables(disc, _classes(fleet), T, 1.0))
    for k in ta:
        assert np.array_equal(ta[k], tb[k])


# ----------------------------- the coarse simulator ---------------------------


def test_single_pool_fleet_matches_homogeneous_simulator_golden_pins():
    def run(core, fleet):
        svc = _service(core, fleet)
        tr = fleet.poisson_trace(5 * svc.max_throughput, 900.0, dt_s=5.0, n_seeds=4, seed=3)
        hom = fleet.simulate(
            tr, svc, fleet.QueueProportionalPolicy(), slo_s=2.0, cold_start_s=30.0, max_queue=1e4
        )
        pool = fleet.PoolConfig(service=svc, cold_start_s=30.0)
        het = fleet.simulate_fleet(
            tr, fleet.FleetConfig((pool,), max_queue=1e4), fleet.QueueProportionalPolicy(),
            slo_s=2.0,
        )
        return hom, het

    (hom_r, het_r), (hom, het) = both(run)
    assert_same_sim(hom_r, hom)
    assert_same_sim(het_r, het)
    # the reference's golden pins (tests/test_fleet_hetero.py), held by the port
    assert hom.served.sum() == pytest.approx(2306702.0)
    assert hom.dropped.sum() == pytest.approx(0.0)
    assert hom.billed_replicas.sum() == pytest.approx(4428.0)
    assert hom.ok_served.sum() == pytest.approx(2305054.0)


@pytest.mark.parametrize(
    "family",
    ["static", "reactive", "queue-prop", "predictive", "pi", "pi-queue", "pid", "fit-to-usage"],
)
def test_homogeneous_policies_match(family):
    def run(core, fleet):
        sc = fleet.mset_scenario(n_signals=256, n_memvec=512, fleet=1, slo_s=1.0, shapes=v5e(core))
        svc = sc.service_for(sc.cheapest_shape())
        tr = fleet.flash_crowd_trace(
            3.5 * svc.max_throughput, 900.0, dt_s=5.0, peak_mult=4.0, n_seeds=3, seed=2
        )
        pol = {
            "static": lambda: fleet.StaticPolicy(6),
            "reactive": lambda: fleet.ReactivePolicy(cooldown_s=60.0),
            "queue-prop": lambda: fleet.QueueProportionalPolicy(),
            "predictive": lambda: fleet.PredictivePolicy(
                sc.rows, sc.constraint(), sc.units_per_step, horizon_s=120.0
            ),
            "pi": lambda: fleet.PIPolicy(4, kp=6.0, ki=0.7, setpoint=0.6),
            "pi-queue": lambda: fleet.PIPolicy(4, kp=3.0, ki=0.2, setpoint=0.5, signal="queue"),
            "pid": lambda: fleet.PIDPolicy(4, kp=6.0, ki=0.7, kd=2.5, setpoint=0.6, windup=5.0),
            "fit-to-usage": lambda: fleet.FitToUsagePolicy(headroom=0.35, window_bins=5),
        }[family]()
        return fleet.simulate(tr, svc, pol, slo_s=1.0, cold_start_s=(60.0, 0.3), cold_start_seed=4)

    assert_same_sim(*both(run))


@pytest.mark.parametrize("family", FAMILIES)
def test_policy_family_decisions_match(family):
    """The policies the kernel-step tests hold each compiled kernel to
    (``torch_fleet_cases.families``) decide as the JAX package's do, bin by bin,
    on the same observations."""
    (fams_r, cls_r), (fams_t, cls_t) = (families(pkg) for pkg in PKGS)
    (fl_r, make_r), (fl_t, make_t) = fams_r[family], fams_t[family]
    pr, pt = make_r(), make_t()
    pr.reset(3)
    pt.reset(3)
    for t, o in enumerate(observations(fl_t, cls_t)):
        a = pr.decide(t, fleet_obs(r_fleet, fl_r, cls_r, o))
        b = pt.decide(t, fleet_obs(t_fleet, fl_t, cls_t, o))
        assert np.array_equal(a, b), f"{family}: bin {t}"


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_scenarios_match(name):
    """Every scenario the compiled backend is held to, on the numpy path of both
    packages."""
    assert_same_sim(GOLDEN[name](pkg=PKGS[0]), GOLDEN[name]())


def test_fidelity_case_and_tuning_slate_match():
    assert_same_sim(fidelity_run(pkg=PKGS[0]), fidelity_run())
    slates = [flash_slate(pkg=pkg) for pkg in PKGS]
    (wl_r, fl_r, params_r, ctx_r), (wl_t, fl_t, params_t, ctx_t) = slates
    assert params_r == params_t
    for p in params_t:
        assert_same_sim(
            r_fleet.simulate_fleet(wl_r, fl_r, r_fleet.PredictivePolicy.from_params(p, **ctx_r)),
            t_fleet.simulate_fleet(wl_t, fl_t, t_fleet.PredictivePolicy.from_params(p, **ctx_t)),
        )


def test_two_pool_hetero_fleet_matches():
    def run(core, fleet):
        sc = fleet.mset_scenario(n_signals=1024, n_memvec=4096, fleet=8, slo_s=1.0,
                                 shapes=v5e(core))
        mixed = sc.fleet_for(["v5e-4", "v5e-16"], cold_start_s=60.0, max_replicas=12)
        base = sc.service_for("v5e-4")
        tr = fleet.flash_crowd_trace(4 * base.max_throughput, 900.0, dt_s=5.0, n_seeds=3, seed=2)
        pol = fleet.HeterogeneousPredictivePolicy(sc.rows, sc.constraint(), sc.units_per_step,
                                                  mixed)
        return fleet.simulate_fleet(tr, mixed, pol, slo_s=sc.slo_s, max_queue=1e6)

    a, b = both(run)
    assert_same_sim(a, b)
    assert b.pool_replicas[:, :, 1].max() > 0  # the burst pool engaged


@pytest.mark.parametrize("disc", DISCIPLINES)
@pytest.mark.parametrize("max_queue", [None, 400.0])
def test_tiered_sla_matches(disc, max_queue):
    def run(core, fleet):
        sc = fleet.mset_scenario(n_signals=256, n_memvec=512, fleet=1, slo_s=1.0, shapes=v5e(core))
        svc = sc.service_for(sc.cheapest_shape())
        wl = fleet.tiered_sla_workload(3.0 * svc.max_throughput, 900.0, dt_s=5.0, n_seeds=3)
        return fleet.simulate(
            wl, svc, fleet.StaticPolicy(6), cold_start_s=30.0, discipline=disc,
            max_queue=max_queue,
        )

    a, b = both(run)
    assert_same_sim(a, b)
    if max_queue is not None:
        assert b.dropped.sum() > 0


# ----------------------------- the substep engine -----------------------------


def _substep_case(core, fleet, n_seeds=3):
    svc = fleet.ServiceModel("svc", core.get_shape("v5e-4"), 3.0, 0.2, 8)
    fl = fleet.FleetConfig(
        (fleet.PoolConfig(svc, cold_start_s=2.0, min_replicas=1, max_replicas=4,
                          initial_replicas=2),)
    )
    wl = fleet.interactive_batch_workload(3.0, 60.0, dt_s=2.0, n_seeds=n_seeds, seed=7)
    return wl, fl


def _reactive(fleet):
    return fleet.ReactivePolicy(upper=0.7, lower=0.3, cooldown_s=4.0)


@pytest.mark.parametrize("disc", DISCIPLINES)
@pytest.mark.parametrize("n_substeps,preemptive", [(2, False), (2, True), (4, True)])
def test_substep_engine_matches(disc, n_substeps, preemptive):
    def run(core, fleet):
        wl, fl = _substep_case(core, fleet)
        return fleet.simulate_fleet(wl, fl, _reactive(fleet), discipline=disc,
                                    n_substeps=n_substeps, preemptive=preemptive)

    a, b = both(run)
    assert_same_sim(a, b)
    assert b.preemptions is not None and b.residue_work is not None


def test_segmented_simulation_with_a_policy_swap_matches():
    def run(core, fleet):
        wl, fl = _substep_case(core, fleet)
        sim = fleet.SegmentedSimulation(wl, fl, _reactive(fleet), discipline="edf", n_substeps=2,
                                        preemptive=True)
        sim.run_until(9)
        part = sim.partial_result()
        sim.swap(policy=fleet.StaticPolicy(3))
        sim.run_until(20).run_until(sim.n_bins)
        return part, sim.result()

    (pa, ra), (pb, rb) = both(run)
    assert_same_sim(pa, pb)
    assert_same_sim(ra, rb)


def test_fleet_state_from_the_reference_resumes_in_the_port():
    """A checkpoint the JAX package's engine wrote, resumed by the port's."""
    (wl_r, fl_r), (wl_t, fl_t) = both(_substep_case)
    kw = dict(discipline="priority", n_substeps=2, preemptive=True)
    ref = r_sim.SegmentedSimulation(wl_r, fl_r, _reactive(r_fleet), **kw).run_until(12)
    port = t_sim.SegmentedSimulation(wl_t, fl_t, _reactive(t_fleet), **kw)
    port.state = t_sim.FleetState(
        **{f.name: np.copy(getattr(ref.state, f.name)) if f.name != "t" else ref.state.t
           for f in dataclasses.fields(r_sim.FleetState)}
    )
    for f in dataclasses.fields(r_sim._SubstepBuffers):
        v = getattr(ref._buf, f.name)
        v = {k: np.copy(a) for k, a in v.items()} if isinstance(v, dict) else np.copy(v)
        setattr(port._buf, f.name, v)
    for sim, fleet in ((ref, r_fleet), (port, t_fleet)):
        sim.swap(policy=fleet.StaticPolicy(3)).run_until(sim.n_bins)
    assert_same_sim(ref.result(), port.result())


# ---------------------------- scenarios and reports ---------------------------


def _same_rows(ra, rb):
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert (x.params, x.shape_name, x.analysis) == (y.params, y.shape_name, y.analysis)
        assert x.terms.as_dict() == y.terms.as_dict()


def test_scenario_rows_match_on_the_reference_shapes():
    ma, mb = both(lambda core, fleet: fleet.mset_scenario(1024, 4096, fleet=8, shapes=v5e(core)))
    _same_rows(ma.rows, mb.rows)
    assert (ma.units_per_step, ma.description) == (mb.units_per_step, mb.description)
    assert ma.cheapest_shape() == mb.cheapest_shape()
    la, lb = both(lambda core, fleet: fleet.lm_decode_scenario("minitron-4b", shapes=v5e(core)))
    _same_rows(la.rows, lb.rows)
    assert la.description == lb.description


def test_scenario_rates_each_shape_on_its_own_hardware():
    """An h100-1 row is priced on the H100 spec, a v5e row on the v5e one."""
    rows = t_fleet.mset_scenario(1024, 4096, shapes=[t_core.get_shape("h100-1")], batches=(64,))
    f, by = t_fleet.scenarios.service_flops_bytes(1024, 4096, 64)
    want = t_core.roofline(f, by, 0.0, 1, t_core.H100)
    assert rows.rows[0].terms.as_dict() == want.as_dict()
    v = t_fleet.mset_scenario(1024, 4096, shapes=[t_core.get_shape("v5e-4")], batches=(64,))
    coll = t_fleet.scenarios.service_collective_bytes(1024, 64)
    assert v.rows[0].terms.as_dict() == t_core.roofline(f, by, coll, 4, t_core.V5E).as_dict()
    assert rows.rows[0].terms.t_compute < v.rows[0].terms.t_compute


def test_reports_render_identically():
    def run(core, fleet):
        sc = fleet.mset_scenario(n_signals=256, n_memvec=512, fleet=1, slo_s=1.0, shapes=v5e(core))
        svc = sc.service_for(sc.cheapest_shape())
        wl = fleet.tiered_sla_workload(3.0 * svc.max_throughput, 600.0, dt_s=5.0, n_seeds=2)
        sims = [
            fleet.simulate(wl, svc, pol, cold_start_s=30.0, discipline=d)
            for pol in (fleet.StaticPolicy(5), fleet.QueueProportionalPolicy())
            for d in ("fifo", "edf")
        ]
        reps = [fleet.summarize(s) for s in sims]
        wm = fleet.window_metrics(sims[0], 10, 60)
        return (
            fleet.comparison_table(reps),
            fleet.class_table(reps),
            fleet.cost_efficiency_table(reps),
            [r.policy for r in fleet.best_per_trace(reps)],
            fleet.telemetry_dashboard(sims[1]),
            dataclasses.astuple(wm),
        )

    a, b = both(run)
    assert a == b
    headers, rows = ["a", "b"], [[1, 2.5], ["x", None]]
    assert r_report.markdown_table(headers, rows) == t_report.markdown_table(headers, rows)
    for s in (None, 3e-7, 0.0123, 4.2, 7300.0):
        assert r_report.fmt_time(s) == t_report.fmt_time(s)


def test_telemetry_streams_match():
    def run(core, fleet):
        wl, fl = _substep_case(core, fleet)
        with fleet.telemetry.session() as tel:
            fleet.simulate_fleet(wl, fl, _reactive(fleet), discipline="edf", n_substeps=2,
                                 preemptive=True)
        return tel.prometheus(), tel.dashboard(), tel.metrics.snapshot()

    a, b = both(run)
    assert a == b


@pytest.mark.parametrize(
    "cls", ["StaticPolicy", "ReactivePolicy", "QueueProportionalPolicy", "PredictivePolicy",
            "HeterogeneousPredictivePolicy", "PIPolicy", "PIDPolicy", "FitToUsagePolicy"],
)
def test_param_spaces_sample_identically(cls):
    a, b = both(lambda core, fleet: getattr(fleet, cls).param_space().sample_lhs(6, seed=3))
    assert a == b
    ga, gb = both(lambda core, fleet: getattr(fleet, cls).param_space().grid(2))
    assert ga == gb
