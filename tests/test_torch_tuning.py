"""The port's tuner (``repro_torch.fleet.tuning``: evaluate, racing, result, tuner)
against ``repro``'s on the scenarios of ``tests/test_tuning.py`` and
``tests/test_portfolio.py``.

``repro`` runs its numpy path (its compiled path needs a jax this box lacks, ROADMAP
R1); the port runs both of its backends on the CPU (``device="cpu"``). The bar is
the reference's own between its two backends: per-candidate, per-seed cost,
attainment, drop and score arrays bit for bit, hence the same winners, frontiers,
surfaces and simulation spend.
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
from repro_torch.fleet import torchsim

import torch_control_cases as cc
from torch_fleet_cases import flash_slate

REF = (r_core, r_fleet)
PORT = (t_core, t_fleet)
BACKENDS = ("numpy", "torch")
CPU = {"device": "cpu"}
BUILDERS = {
    "static": cc.static_scenario,
    "portfolio-worst_case": cc.portfolio_scenario,
    "portfolio-cvar": lambda pkg, b, **d: cc.portfolio_scenario(pkg, b, "cvar(0.67)", **d),
    "portfolio-mean": lambda pkg, b, **d: cc.portfolio_scenario(pkg, b, "mean", **d),
    "predictive": cc.predictive_scenario,
}
STATIC = [{"n_replicas": n} for n in (2, 4, 5, 6, 9, 14)]
FOUR = [{"n_replicas": n} for n in (2, 5, 9, 14)]


def scenarios(name, backend):
    """(repro's scenario on numpy, the port's on ``backend``) for a named case."""
    build = BUILDERS[name]
    return build(REF, "numpy"), build(PORT, backend, **CPU)


def report_json(rep):
    """A TuningReport's JSON (spans excluded), through a JSON round trip."""
    return json.loads(json.dumps(rep.to_json(include_spans=False)))


def test_tuning_names_equal():
    import repro.fleet.tuning as r_tuning
    import repro_torch.fleet.tuning as t_tuning

    assert t_tuning.__all__ == r_tuning.__all__


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize(
    "name,candidates",
    [
        ("static", STATIC),
        ("portfolio-worst_case", FOUR),
        ("portfolio-cvar", FOUR),
        ("portfolio-mean", FOUR),
        ("predictive", None),
    ],
)
def test_evaluate_candidates_bit_for_bit(name, candidates, backend):
    ref, port = scenarios(name, backend)
    if candidates is None:
        candidates = t_fleet.PredictivePolicy.param_space().sample_lhs(6, seed=0)
    want = r_fleet.evaluate_candidates(
        ref, candidates, r_fleet.Objective(min_attainment=0.99), s0=1, s1=ref.n_seeds
    )
    got = t_fleet.evaluate_candidates(
        port, candidates, t_fleet.Objective(min_attainment=0.99), s0=1, s1=port.n_seeds
    )
    assert cc.same_evals(want, got)
    for a, b in zip(want, got):
        assert a.p99_s() == b.p99_s()


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_cutting_dims_batch_per_candidate_fleets_and_disciplines(backend):
    """Candidates that differ in discipline and quota: the torch slate stacks one
    fleet and one set of cohort tables per candidate."""
    ref, space = cc.quota_scenario(REF)
    port, _ = cc.quota_scenario(PORT, backend, **CPU)
    cands = space.sample_lhs(6, seed=4)
    assert len({c["discipline"] for c in cands}) > 1
    want = r_fleet.evaluate_candidates(ref, cands, r_fleet.Objective())
    got = t_fleet.evaluate_candidates(port, cands, t_fleet.Objective())
    assert cc.same_evals(want, got)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("init_seeds", [1, 2, 4])
def test_race_same_survivors_culls_and_spend(init_seeds, backend):
    ref, port = scenarios("static", backend)
    grid = [{"n_replicas": n} for n in range(1, 19)]
    want = r_fleet.race(ref, grid, r_fleet.Objective(0.99), init_seeds=init_seeds)
    got = t_fleet.race(port, grid, t_fleet.Objective(0.99), init_seeds=init_seeds)
    assert got.winner.params == want.winner.params
    assert [e.params for e in got.survivors] == [e.params for e in want.survivors]
    assert got.culled_at_round == want.culled_at_round
    assert (got.sims_used, got.full_budget) == (want.sims_used, want.full_budget)
    assert cc.same_evals(want.evals, got.evals)
    assert [e.n_rounds for e in got.evals] == [e.n_rounds for e in want.evals]


@pytest.mark.parametrize("backend", BACKENDS)
def test_exhaustive_and_portfolio_race_equal(backend):
    ref, port = scenarios("portfolio-worst_case", backend)
    grid = t_fleet.ParamSpace((t_fleet.Integer("n_replicas", 1, 16),)).grid(16)
    for fn in ("exhaustive", "race"):
        want = getattr(r_fleet, fn)(ref, grid, r_fleet.Objective())
        got = getattr(t_fleet, fn)(port, grid, t_fleet.Objective())
        assert got.winner.params == want.winner.params
        assert got.sims_used == want.sims_used
        assert got.culled_at_round == want.culled_at_round
        assert cc.same_evals(want.evals, got.evals)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["static", "portfolio-worst_case", "predictive"])
def test_tune_same_report(name, backend):
    """Same winner, frontier, surface coefficients and spend: the whole report's
    JSON (spans excluded) is equal, and each package reads the other's."""
    ref, port = scenarios(name, backend)
    family = "PredictivePolicy" if name == "predictive" else "StaticPolicy"
    if name == "predictive":
        baseline = {"horizon_s": 60.0, "window_bins": 12, "headroom": 0.85}
    else:
        baseline = {"n_replicas": 6}
    reports = [
        fm.tune(
            scen,
            getattr(fm, family).param_space(),
            fm.Objective(),
            fm.TuningBudget(n_candidates=10),
            seed=7,
            baseline=baseline,
        )
        for fm, scen in ((r_fleet, ref), (t_fleet, port))
    ]
    want, got = reports
    assert got.winner.params == want.winner.params
    assert [e.params for e in got.frontier] == [e.params for e in want.frontier]
    assert got.sims_used == want.sims_used
    assert got.surface_names == want.surface_names
    if want.surface is not None:
        assert got.surface.to_json() == want.surface.to_json()
    assert report_json(got) == report_json(want)
    assert t_fleet.TuningReport.from_json(report_json(want)).winner.params == want.winner.params
    assert r_fleet.TuningReport.from_json(report_json(got)).sims_used == want.sims_used
    assert isinstance(got.build_policy(), getattr(t_fleet, family))
    assert got.summary().splitlines()[:4] == want.summary().splitlines()[:4]


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_start_retune_equal(backend):
    ref, port = scenarios("static", backend)
    out = []
    for fm, scen in ((r_fleet, ref), (t_fleet, port)):
        space = fm.ParamSpace((fm.Integer("n_replicas", 1, 24, log=True),))
        inc = fm.tune(scen, space, fm.Objective(0.95), fm.TuningBudget(5, init_seeds=1))
        cands = fm.warm_start_candidates(inc, space, 8, seed=3, jitter=0.2)
        warm = fm.tune(
            scen, space, inc.objective, fm.TuningBudget(4, init_seeds=1), seed=5, warm_start=inc
        )
        out.append((cands, report_json(warm)))
    assert out[1] == out[0]


def test_race_column_equals_per_tier_race():
    """``race_column`` needs the compiled backend, which ``repro`` cannot run here
    (R1): the port's column race on the torch backend equals, tier by tier, the
    port's and ``repro``'s standalone numpy races, at a smaller shared spend."""
    slos = (1.0, 2.5, 6.0)
    cands = t_fleet.PIPolicy.param_space().sample_lhs(6, seed=3)

    def scen(pkg, slo, backend, **dev):
        fm = pkg[1]
        svc = cc.service(pkg)
        tr = fm.poisson_trace(3.0 * svc.max_throughput, 400.0, dt_s=5.0, n_seeds=4, seed=0)
        return fm.TuningScenario(
            name=f"tier{slo}",
            workload=fm.Workload.from_trace(tr, slo),
            fleet=cc.fleet(pkg, svc),
            policy_cls=fm.PIPolicy,
            context={"slo_s": slo},
            backend=backend,
            **dev,
        )

    results, shared = t_fleet.race_column(
        scen(PORT, slos[0], "torch", **CPU), cands, t_fleet.Objective(), slos
    )
    for slo, rr in zip(slos, results):
        solos = (
            r_fleet.race(scen(REF, slo, "numpy"), cands, r_fleet.Objective()),
            t_fleet.race(scen(PORT, slo, "numpy"), cands, t_fleet.Objective()),
        )
        for solo in solos:
            assert rr.winner.params == solo.winner.params
            assert np.array_equal(rr.winner.score, solo.winner.score)
            assert (rr.sims_used, rr.full_budget) == (solo.sims_used, solo.full_budget)
            assert rr.culled_at_round == solo.culled_at_round
    assert max(r.sims_used for r in results) <= shared < sum(r.sims_used for r in results)


def test_backend_choice_and_device():
    """"jax" is refused naming "torch"; "auto" runs numpy for a custom
    ``build_policy`` and the compiled path for a family with a kernel, which on
    the default device (the card) raises without one and never falls back."""
    cands = [{"n_replicas": 4}]
    obj = t_fleet.Objective()
    with pytest.raises(ValueError, match="torch"):
        t_fleet.evaluate_candidates(cc.static_scenario(PORT, "jax"), cands, obj)
    custom = cc.static_scenario(PORT, "auto")
    custom.build_policy = lambda p: t_fleet.StaticPolicy(p["n_replicas"])
    want = t_fleet.evaluate_candidates(cc.static_scenario(PORT, "numpy"), cands, obj)
    assert cc.same_evals(want, t_fleet.evaluate_candidates(custom, cands, obj))
    custom.backend = "torch"
    with pytest.raises(ValueError, match="cannot batch"):
        t_fleet.evaluate_candidates(custom, cands, obj)
    if not torch.cuda.is_available():
        for backend in ("auto", "torch"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                t_fleet.evaluate_candidates(cc.static_scenario(PORT, backend), cands, obj)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cc.static_scenario(PORT, "auto").simulate(cands[0], 0, 2)


def test_tiled_round_and_dispatch_spans():
    """A slate wider than the tile streams through fixed-width chunks that share one
    dispatch signature (cold, then warm), equal to one wide dispatch; a tune's
    timing breakdown renders the ``torchsim.dispatch`` spans."""
    svc = cc.service(PORT)
    tr = t_fleet.poisson_trace(3.0 * svc.max_throughput, 300.0, dt_s=5.0, n_seeds=3, seed=0)
    kw = dict(
        name="t",
        workload=tr,
        fleet=cc.fleet(PORT, svc),
        policy_cls=t_fleet.StaticPolicy,
        context={"slo_s": 2.0},
        backend="torch",
        **CPU,
    )
    cands = [{"n_replicas": 1 + (i % 16)} for i in range(40)]
    obj = t_fleet.Objective()
    torchsim.clear_compiled()
    with t_fleet.telemetry.session() as tel:
        tiled = t_fleet.evaluate_candidates(t_fleet.TuningScenario(tile=16, **kw), cands, obj)
    spans = [s.attrs for s in tel.tracer.roots if s.name == "torchsim.dispatch"]
    assert [(a["kind"], a["tile"], a["padded"]) for a in spans] == [
        ("cold", 0, 16),
        ("warm", 1, 16),
        ("warm", 2, 16),
    ]
    flat = t_fleet.evaluate_candidates(t_fleet.TuningScenario(tile=None, **kw), cands, obj)
    assert cc.same_evals(tiled, flat)
    with t_fleet.telemetry.session():
        rep = t_fleet.tune(
            t_fleet.TuningScenario(**kw),
            t_fleet.StaticPolicy.param_space(),
            budget=t_fleet.TuningBudget(6),
            seed=0,
        )
    text = rep.timing_breakdown()
    assert "torchsim.dispatch" in text and "tune.race.round" in text


def test_slate_arguments_generalises_the_plain_call():
    """The tuner's call of the one builder (per-candidate fleets and disciplines,
    sticky windows) reduces to the plain call when they are all the same."""
    wl, fleet, params, ctx = flash_slate(n=3, n_seeds=2, duration=300.0)
    pols = [t_fleet.PredictivePolicy.from_params(p, **ctx) for p in params]
    k0, plain = torchsim.slate_arguments(wl, fleet, pols)
    k1, full = torchsim.slate_arguments(
        [wl], fleet, pols, fleets=[fleet] * 3, disciplines=["fifo"] * 3, windows=(0, 0)
    )
    assert k0 is k1 and plain.keys() == full.keys()
    for k, v in plain.items():
        if isinstance(v, dict):
            assert all(np.array_equal(v[j], full[k][j]) for j in v), k
        else:
            assert np.array_equal(np.asarray(v), np.asarray(full[k])), k
    W = torchsim.slate_windows(pols)
    wide, _ = torchsim.slate_arguments(wl, fleet, pols, windows=(W[0] + 7, W[1]))
    assert wide is not k0  # a wider ring is another kernel configuration
