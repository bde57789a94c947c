"""The port's closed-loop controller (``repro_torch.fleet.control``) against
``repro``'s, on the CPU: ``tests/test_control.py``'s quiet run and factor-3 drift
case, and ``tests/test_oracle.py``'s oracle hit, miss and bare-table cases.

``repro`` runs its numpy path (R1); the port runs its numpy path and its torch
backend on the CPU (``device="cpu"``: the re-tunes' racing rounds and the drift
probe). Each run's event sequence (kind, bin), degradation estimate, active params,
and re-tune and swap records must equal the reference's.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as r_core
import repro.fleet as r_fleet
import repro_torch.core as t_core
import repro_torch.fleet as t_fleet

import torch_control_cases as cc

REF = (r_core, r_fleet)
PORT = (t_core, t_fleet)
BACKENDS = ("numpy", "torch")
CPU = {"device": "cpu"}
GRIDS = {"hit": cc.HIT_GRID, "miss": cc.MISS_GRID, "bare": cc.BARE_GRID}


def test_fleet_names_equal():
    """``repro_torch.fleet`` exports what ``repro.fleet`` does, in its order; so do
    the control and oracle packages."""
    import repro.fleet.control as r_control
    import repro.fleet.oracle as r_oracle
    import repro_torch.fleet.control as t_control
    import repro_torch.fleet.oracle as t_oracle

    assert t_fleet.__all__ == r_fleet.__all__
    assert t_control.__all__ == r_control.__all__
    assert t_oracle.__all__ == r_oracle.__all__
    for name in t_fleet.__all__:
        assert getattr(t_fleet, name) is not None, name


@pytest.fixture(scope="module")
def ref_runs():
    """``repro``'s quiet run and drift-case run, on numpy."""
    ctl, _, _ = cc.controller(REF)
    quiet = ctl.run()
    ctl, case = cc.drift_case(REF)
    return {"quiet": quiet, "drift": ctl.run(case)}


def oracle_run(pkg, which, backend="numpy", **dev):
    """``test_oracle.py``'s closed-loop case with the ``which`` table, the oracle given
    as a ``ScopingOracle`` (hit, miss) or as a bare ``OracleTable`` (bare)."""
    fm = pkg[1]
    svc, fl, case, scen, incumbent = cc.oracle_drift_setup(pkg, backend, **dev)
    table = cc.oracle_table(pkg, svc, fl, GRIDS[which], backend, **dev)
    ctl = fm.ClosedLoopController(
        scen,
        incumbent,
        segment_bins=30,
        oracle=table if which == "bare" else fm.ScopingOracle(table),
        objective=fm.Objective(min_attainment=0.9),
    )
    assert isinstance(ctl.oracle, fm.ScopingOracle)
    return ctl.run(case)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quiet_run_never_acts(ref_runs, backend):
    ctl, _, ts = cc.controller(PORT, backend, **CPU)
    res = ctl.run()
    want = ref_runs["quiet"]
    assert cc.decision_record(res) == cc.decision_record(want)
    assert res.timeline() == want.timeline() == "(quiet run)"
    assert res.n_alarms == 0 and res.est_factor == 1.0
    assert res.sim.served.shape[1] == ts.workload.n_bins


@pytest.mark.parametrize("backend", BACKENDS)
def test_drift_case_detects_and_recovers_as_the_reference(ref_runs, backend):
    ctl, case = cc.drift_case(PORT, backend, **CPU)
    res = ctl.run(case)
    want = ref_runs["drift"]
    assert cc.events_of(res) == cc.events_of(want)
    assert res.est_factor == want.est_factor and res.est_factor > 1.5
    assert res.active_params == want.active_params != res.incumbent_params
    assert cc.decision_record(res) == cc.decision_record(want)
    assert res.timeline() == want.timeline()
    got_reports = [r.to_json(include_evals=False) for r in res.retunes]
    assert got_reports == [r.to_json(include_evals=False) for r in want.retunes]
    for kind in ("world-change", "drift-alarm", "retune", "swap"):
        assert kind in [e.kind for e in res.events]


@pytest.mark.parametrize("which", ["hit", "miss", "bare"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_oracle_consult_as_the_reference(which, backend):
    """An oracle hit swaps without a re-tune, a miss falls back to one, a bare table is
    wrapped; the port's table is built on ``backend`` and its controller re-tunes on
    it."""
    want = oracle_run(REF, which)
    res = oracle_run(PORT, which, backend, **CPU)
    assert cc.events_of(res) == cc.events_of(want)
    assert cc.decision_record(res) == cc.decision_record(want)
    assert [a.params for a in res.oracle_answers] == [a.params for a in want.oracle_answers]
    assert [a.reason for a in res.oracle_answers] == [a.reason for a in want.oracle_answers]
    if which == "miss":
        assert res.oracle_misses >= 1 and res.retunes
    else:
        assert res.oracle_hits >= 1 and not res.retunes


def test_scenario_helpers_equal():
    wl_r, _ = cc.control_workload(REF, duration=400.0)
    wl_t, _ = cc.control_workload(PORT, duration=400.0)
    a, b = r_fleet.tail_workload(wl_r, 30), t_fleet.tail_workload(wl_t, 30)
    assert (a.n_bins, repr(a.classes)) == (b.n_bins, repr(b.classes))
    assert (a.traces[0].arrivals == b.traces[0].arrivals).all()
    fl_r, fl_t = cc.fleet(REF, cc.service(REF)), cc.fleet(PORT, cc.service(PORT))
    ca = r_fleet.service_degradation_case(wl_r, fl_r, factor=2.0)
    cb = t_fleet.service_degradation_case(wl_t, fl_t, factor=2.0)
    assert ca.drift_bins() == cb.drift_bins() and ca.description == cb.description
    t = ca.drift_bins()[0]
    assert ca.inject[t].pools[0].service.t_fixed == cb.inject[t].pools[0].service.t_fixed
    with pytest.raises(ValueError):
        t_fleet.service_degradation_case(wl_t, fl_t, factor=1.0)
    with pytest.raises(ValueError):
        t_fleet.tail_workload(wl_t, wl_t.n_bins)


def test_controller_devices():
    """The default probe and the re-tunes take the scenario's device: on a box with no
    card, the default device raises instead of quietly running on the CPU."""
    ctl, _, ts = cc.controller(PORT, "torch", **CPU)
    assert ctl._probe0.device == "cpu"
    assert ctl._tail_scenario(10, 2.0).device == "cpu"
    if not torch.cuda.is_available():
        ts.device = None
        card = t_fleet.ClosedLoopController(ts, ctl.incumbent, segment_bins=15)
        assert card._probe0.device is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            card.run()
