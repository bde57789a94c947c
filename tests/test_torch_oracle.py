"""The port's scoping oracle (``repro_torch.fleet.oracle``: features, build, oracle,
verify) against ``repro``'s on ``tests/test_oracle.py``'s scenarios, on the CPU.

``repro`` builds and verifies on its numpy path (R1). The port builds per cell on
numpy, where its table must equal the reference's, and by SLO column on its torch
backend (``device="cpu"``), where its cells must equal both per-cell builds while
it simulates fewer trajectories.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import json

import numpy as np

import repro.core as r_core
import repro.fleet as r_fleet
import repro_torch.core as t_core
import repro_torch.fleet as t_fleet

import torch_control_cases as cc

REF = (r_core, r_fleet)
PORT = (t_core, t_fleet)
CPU = {"device": "cpu"}
ANSWER_FIELDS = (
    "ok",
    "reason",
    "slo_s",
    "params",
    "cost_usd_hr",
    "cost_bound_usd_hr",
    "attainment",
    "score",
    "cell_idx",
    "exact",
    "corner_idx",
    "corner_weights",
)


def build(pkg, backend="numpy", **kw):
    """``test_oracle.py``'s ``small_oracle`` table built with ``pkg``."""
    fm = pkg[1]
    svc = cc.service(pkg)
    return fm.build_oracle(
        cc.small_oracle_grid(pkg, svc),
        cc.fleet(pkg, svc),
        fm.PIPolicy,
        fm.PIPolicy.param_space(),
        objective=fm.Objective(min_attainment=0.9),
        budget=fm.TuningBudget(n_candidates=5, init_seeds=1),
        backend=backend,
        **kw,
    )


@pytest.fixture(scope="module")
def tables():
    return {
        "ref": build(REF),
        "port-numpy": build(PORT, **CPU),
        "port-column": build(PORT, "torch", **CPU),
    }


def without_backend(table):
    d = json.loads(json.dumps(table.to_json(), default=float))
    d["build_info"].pop("backend")
    return d


def cells_json(table):
    return [c.to_json() for _, c in sorted(table.cells.items())]


def answer(ans):
    """An OracleAnswer's fields but the measured latency, as plain JSON values."""
    d = {k: getattr(ans, k) for k in ANSWER_FIELDS}
    d["features"] = None if ans.features is None else ans.features.as_dict()
    return json.loads(json.dumps(d, default=str))


def test_oracle_names_equal():
    import repro.fleet.oracle as r_oracle
    import repro_torch.fleet.oracle as t_oracle

    assert t_oracle.__all__ == r_oracle.__all__


@pytest.mark.parametrize(
    "kind,args",
    [
        ("poisson_trace", (900.0, 300.0)),
        ("flash_crowd_trace", (500.0, 300.0)),
        ("diurnal_trace", (2000.0, 3600.0)),
        ("ramp_trace", (4000.0, 1000.0, 600.0)),
    ],
)
def test_featurize_bit_for_bit(kind, args):
    want, got = (
        fm.featurize(getattr(fm, kind)(*args, dt_s=10.0, n_seeds=2, seed=1))
        for fm in (r_fleet, t_fleet)
    )
    assert got.as_dict() == want.as_dict()
    wl_r, wl_t = (
        fm.tiered_sla_workload(3000.0, 600.0, dt_s=5.0, n_seeds=2, seed=0)
        for fm in (r_fleet, t_fleet)
    )
    assert t_fleet.featurize(wl_t).as_dict() == r_fleet.featurize(wl_r).as_dict()
    scaled = t_fleet.TraceFeatures.from_dict(want.as_dict()).scaled(2.5)
    assert scaled.as_dict() == want.scaled(2.5).as_dict()


@pytest.mark.parametrize("burst", [1.0, 1.4, 2.5, 4.0])
def test_canonical_trace_bit_for_bit(burst):
    kw = dict(duration_s=600.0, dt_s=5.0, n_seeds=2, seed=7)
    want = r_fleet.canonical_trace(2000.0, burst, **kw)
    got = t_fleet.canonical_trace(2000.0, burst, **kw)
    assert got.name == want.name
    assert np.array_equal(got.rate, want.rate) and np.array_equal(got.arrivals, want.arrivals)
    with pytest.raises(ValueError, match="burstiness"):
        t_fleet.canonical_trace(2000.0, 50.0, duration_s=600.0, dt_s=5.0)


def test_per_cell_table_equals_the_reference(tables, tmp_path):
    """The port's per-cell numpy build: the table's JSON equals ``repro``'s, and each
    package's ``OracleTable`` loads the other's file."""
    ref, port = tables["ref"], tables["port-numpy"]
    assert without_backend(port) == without_backend(ref)
    assert port.build_info["backend"] == ref.build_info["backend"] == "numpy"
    ref.save(tmp_path / "ref.json")
    port.save(tmp_path / "port.json")
    a = t_fleet.OracleTable.load(tmp_path / "ref.json")
    b = r_fleet.OracleTable.load(tmp_path / "port.json")
    assert cells_json(a) == cells_json(ref) and cells_json(b) == cells_json(port)
    assert a.summary() == ref.summary()


def test_column_build_equals_the_per_cell_builds(tables):
    """The torch backend's column batch: every cell (winner, score, frontier) equals
    both per-cell numpy builds, at fewer simulated trajectories."""
    col, cell, ref = tables["port-column"], tables["port-numpy"], tables["ref"]
    assert col.build_info["backend"] == "torch"
    assert cells_json(col) == cells_json(cell) == cells_json(ref)
    assert col.build_info["sims_used"] < cell.build_info["sims_used"]
    assert col.build_info["n_cells"] == cell.build_info["n_cells"] == 8


def test_query_answers_equal(tables):
    """Exact grid points, interpolated points and refusals, answer for answer."""
    ref, port = tables["ref"], tables["port-numpy"]
    ro, to = r_fleet.ScopingOracle(ref), t_fleet.ScopingOracle(port)
    g = ref.grid
    mid = float(np.sqrt(g.mean_rates[0] * g.mean_rates[1]))
    lo, hi = g.mean_rates[0], g.mean_rates[-1]
    queries = [(c.mean_rate, c.burstiness, c.slo_s) for c in ref.cells.values()]
    queries += [
        (mid, 1.4, 1.7),
        (lo * 1.3, 1.2, 2.0),
        (hi * 100, 1.2, 2.0),
        (lo, 50.0, 2.0),
        (lo, 1.2, 300.0),
        (mid, 1.1, -1.0),
    ]
    for mr, b, slo in queries:
        want = ro.query(r_fleet.TraceFeatures(mr, b, 0.0), slo)
        got = to.query(t_fleet.TraceFeatures(mr, b, 0.0), slo)
        assert answer(got) == answer(want)
        assert got.latency_us > 0
    tr_r, tr_t = (
        fm.flash_crowd_trace(mid, 400.0, dt_s=5.0, peak_mult=1.8, n_seeds=2, seed=9)
        for fm in (r_fleet, t_fleet)
    )
    for f in (1.0, 1.6):
        assert answer(to.query(tr_t, 2.0, rate_factor=f)) == answer(
            ro.query(tr_r, 2.0, rate_factor=f)
        )
    stats = t_fleet.query_latency_us(to, t_fleet.TraceFeatures(mid, 1.2, 0.0), 2.0, n=20)
    assert stats["n"] == 20 and stats["median_us"] > 0


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_verify_report_equal(tables, backend):
    ref = tables["ref"]
    want = r_fleet.verify_oracle(
        ref,
        cc.fleet(REF, cc.service(REF)),
        r_fleet.PIPolicy,
        n_samples=2,
        seed=5,
        backend="numpy",
    )
    got = t_fleet.verify_oracle(
        t_fleet.OracleTable.from_json(ref.to_json()),
        cc.fleet(PORT, cc.service(PORT)),
        t_fleet.PIPolicy,
        n_samples=2,
        seed=5,
        backend=backend,
        **CPU,
    )
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    assert got.summary() == want.summary() and got.ok() == want.ok()


def test_exhaustive_budget_columns_equal():
    """``test_oracle.py``'s SLO-monotone case (racing off: every tier scores the same
    candidates, so the column path is declined and cells are tuned one by one)."""

    def run(pkg, backend, **dev):
        fm = pkg[1]
        svc = cc.service(pkg)
        grid = fm.OracleGrid(
            mean_rates=(3.0 * svc.max_throughput,),
            burstiness=(1.5,),
            slos=(1.0, 2.0, 4.0),
            duration_s=400.0,
            dt_s=5.0,
            n_seeds=2,
            seed=11,
        )
        return fm.build_oracle(
            grid,
            cc.fleet(pkg, svc),
            fm.PIPolicy,
            fm.PIPolicy.param_space(),
            objective=fm.Objective(min_attainment=0.9),
            budget=fm.TuningBudget(n_candidates=4, racing=False),
            backend=backend,
            **dev,
        )

    want = run(REF, "numpy")
    got = run(PORT, "torch", **CPU)
    assert cells_json(got) == cells_json(want)
    assert got.build_info["sims_used"] == want.build_info["sims_used"]


def test_build_on_the_default_device_needs_a_card():
    """``device=None`` is the card: without one the compiled build raises rather than
    running on the CPU."""
    from repro_torch._device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(PORT, "auto")
