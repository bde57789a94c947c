"""The port's slice end to end on the CPU, against the JAX package:
TPSS -> memory vectors -> MSET2 -> SPRT -> measured scoping -> surface -> recommender.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax.numpy as jnp
import numpy as np

from repro.configs import mset_paper as jax_mset_paper
from repro.core import catalog as jcatalog
from repro.core import cost_model as jcost
from repro.core import recommender as jrecommender
from repro.core import scoping as jscoping
from repro.core import surfaces as jsurfaces
from repro.mset import mset2 as jmset2
from repro.mset import service as jservice
from repro.mset.sprt import SPRTParams as JaxSPRTParams
from repro.mset.sprt import sprt as jax_sprt
from repro_torch import core
from repro_torch.configs import get_config, mset_paper
from repro_torch.data import TokenPipeline
from repro_torch.launch import scope
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import StepBuilder
from repro_torch.launch.train import TrainJob
from repro_torch.launch.train import train as train_lm
from repro_torch.models import Model, build_model
from repro_torch.mset import MSETModel, SPRTParams, estimate, service, sprt, train
from repro_torch.tpss import TPSSParams, draw, synthesize
from torch_parity_data import WELL_POSED, telemetry

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------ the slice ----------------------------------


@pytest.mark.parametrize("impl,case", [("interpret", WELL_POSED[2]), ("ref", WELL_POSED[0])])
def test_slice_residuals_match_reference(impl, case):
    seed, n_signals, n_obs, n_memvec = case
    X = telemetry(seed, n_obs, n_signals)
    n_tr = n_obs * 3 // 4
    jm = jmset2.train(jnp.asarray(X[:n_tr]), n_memvec, impl=impl)
    _, res_ref = jmset2.estimate(jm, jnp.asarray(X[n_tr:]), impl=impl)
    model = train(torch.from_numpy(X[:n_tr]), n_memvec)
    _, res = estimate(model, torch.from_numpy(X[n_tr:]))
    # Memory vectors are all distinct here, so G is well conditioned (see ROADMAP, R3).
    assert len(np.unique(model.D.numpy(), axis=0)) == n_memvec
    # D agrees to ~1e-6 (standardization summed in another order) and the diagonal of
    # G to ~5e-4 (cancellation in |x|^2 + |x|^2 - 2 x.x, in both packages); Ginv
    # (condition number in the hundreds) carries that into x_hat at ~1e-4 of the
    # signals' scale. The bar is 1e-3 of it.
    tol = 1e-3 * np.abs(X).max()
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), atol=tol, rtol=0)
    # SPRT downstream: the same alarms from the same residuals
    r = res.numpy()
    sigma = r[: len(r) // 2].std(0)
    a_ref, _, _ = jax_sprt(jnp.asarray(r), jnp.asarray(sigma), JaxSPRTParams())
    a, _, _ = sprt(res, torch.from_numpy(sigma), SPRTParams())
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


def test_scope_mset_on_cpu(tmp_path):
    grid = {"n_signals": [4, 8], "n_memvec": [16, 32], "n_observations": [256]}
    out = tmp_path / "scope.json"
    res, surf = scope.run_mset(grid, reps=1, out=str(out), device="cpu", verbose=False)
    cells = [(r.params["n_signals"], r.params["n_memvec"]) for r in res.rows]
    assert cells == [(4, 16), (4, 32), (8, 16), (8, 32)]
    assert all(r.mean_s > 0 and r.reps == 1 for r in res.rows)
    assert np.isfinite(surf.r2)
    rows = json.loads(out.read_text())
    assert [r["device"] for r in rows] == ["cpu"] * 4
    assert rows[0]["n_memvec"] == 16 and rows[0]["mean_s"] == res.rows[0].mean_s


def test_scope_cli_needs_mset():
    with pytest.raises(SystemExit):
        scope.main(["--grid", "small", "--device", "cpu"])


def test_cell_seed_is_stable_across_processes():
    # hash() of a str changes between processes; the cell seed must not
    params = {"n_signals": 32, "n_memvec": 128, "n_observations": 4096}
    assert scope.cell_seed(params) == scope.cell_seed(dict(reversed(list(params.items()))))
    code = "from repro_torch.launch.scope import cell_seed; print(cell_seed(%r))" % params
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="123")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert int(out.stdout) == scope.cell_seed(params)


def test_full_width_cell_is_the_widest_fig8_cell():
    assert scope.FULL_WIDTH_CELL == {"n_signals": 1024, "n_memvec": 8192, "n_observations": 65536}


def test_surveillance_workload_trains_on_twice_the_memory_vectors():
    wl = scope.mset_workload("cpu", split=scope.surveillance_split)
    r = wl({"n_signals": 4, "n_memvec": 16, "n_observations": 40})()
    assert r.shape == (40, 4) and bool(torch.isfinite(r).all())


# ------------------------------ scoping engine -----------------------------


def _raise(exc):
    def f(*_):
        raise exc

    return f


@pytest.mark.parametrize("where", ["workload", "run"])
def test_run_measured_propagates_errors_other_than_oom(where):
    def workload(params):
        if where == "workload":
            raise RuntimeError("kernel failed to build")
        return _raise(RuntimeError("kernel failed to launch"))

    with pytest.raises(RuntimeError, match="kernel failed"):
        core.ContainerStress().run_measured(workload, {"a": [1, 2]})


@pytest.mark.parametrize("where", ["workload", "run"])
def test_run_measured_skips_out_of_memory_cells(where):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")

    def workload(params):
        if params["a"] == 2:
            if where == "workload":
                raise oom
            return _raise(oom)
        return lambda: None

    res = core.ContainerStress().run_measured(workload, {"a": [1, 2, 3]}, reps=2)
    assert [r.params["a"] for r in res.rows] == [1, 3]


# ------------------------------ surfaces and recommender -------------------


def _rows(pkg_scoping, pkg_cost, names, rng):
    t = rng.uniform(0.1, 5.0, len(names))
    return [
        pkg_scoping.CellResult(
            params={"chips": i},
            shape_name=name,
            terms=pkg_cost.RooflineTerms(float(ti), float(ti) * 0.8, 0.0),
            analysis={"peak_memory_per_device": float(rng.uniform(1e9, 3e10))},
        )
        for i, (name, ti) in enumerate(zip(names, t))
    ]


# The port's v5e entries; other tests register shapes in the reference's catalog.
V5E_NAMES = [s.name for s in core.CATALOG if s.hw is core.V5E]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recommender_matches_reference_on_v5e_rows(seed):
    names = V5E_NAMES
    ref_rows = _rows(jscoping, jcost, names, np.random.default_rng(seed))
    rows = _rows(core.scoping, core.cost_model, names, np.random.default_rng(seed))
    for kw in [dict(max_step_latency_s=2.0), dict(max_usd_per_hour=50.0), {}]:
        ref = jrecommender.recommend(ref_rows, jrecommender.Constraint(**kw))
        rec = core.recommend(rows, core.Constraint(**kw))
        assert rec.ranking == ref.ranking and rec.reason == ref.reason
        assert (rec.shape and rec.shape.name) == (ref.shape and ref.shape.name)
        ranked = core.feasible_ranking(rows, core.Constraint(**kw))
        ref_ranked = jrecommender.feasible_ranking(ref_rows, jrecommender.Constraint(**kw))
        assert [s.name for *_, s in ranked] == [s.name for *_, s in ref_ranked]


def test_surface_fit_render_and_plan_match_reference():
    rng = np.random.default_rng(3)
    X = np.array([[s, m] for s in (8, 16, 32, 64) for m in (64, 128, 256, 512)], float)
    y = 1e-4 * X[:, 0] ** 0.7 * X[:, 1] ** 1.3 * rng.uniform(0.9, 1.1, len(X))
    ref = jsurfaces.fit_response_surface(["n_signals", "n_memvec"], X, y)
    surf = core.fit_response_surface(["n_signals", "n_memvec"], X, y)
    np.testing.assert_array_equal(surf.coef, ref.coef)
    assert surf.r2 == ref.r2 and surf.degree == ref.degree
    Q = np.array([[10.0, 100.0], [128.0, 1024.0]])
    np.testing.assert_array_equal(surf.predict_many(Q), ref.predict_many(Q))
    assert surf.extrapolated == ref.extrapolated
    rows = [core.CellResult({"n_signals": a, "n_memvec": b}, mean_s=c) for (a, b), c in zip(X, y)]
    ref_rows = [jscoping.CellResult(r.params, mean_s=r.mean_s) for r in rows]
    xs, ys, Z = core.grid_to_matrix(rows, "n_memvec", "n_signals")
    assert core.render_ascii_surface(xs, ys, Z, "m", "s", "t") == jsurfaces.render_ascii_surface(
        *jsurfaces.grid_to_matrix(ref_rows, "n_memvec", "n_signals"), "m", "s", "t"
    )
    shapes = [core.get_shape("v5e-4"), core.get_shape("v5e-16")]
    ref_shapes = [jcatalog.get_shape("v5e-4"), jcatalog.get_shape("v5e-16")]
    cons = dict(max_step_latency_s=0.05)
    plan = core.elasticity_plan(
        {s.name: surf for s in shapes}, shapes, "n_signals", [8, 32, 64], {"n_memvec": 256},
        core.Constraint(**cons),
    )
    ref_plan = jrecommender.elasticity_plan(
        {s.name: ref for s in ref_shapes}, ref_shapes, "n_signals", [8, 32, 64], {"n_memvec": 256},
        jrecommender.Constraint(**cons),
    )
    assert plan == ref_plan


def test_catalog_keeps_v5e_and_adds_h100_nodes():
    assert len(V5E_NAMES) == 8
    for name in V5E_NAMES:
        s, ref = core.get_shape(name), jcatalog.get_shape(name)
        assert (s.mesh_shape, s.axes, s.chips, s.price_per_hour) == (
            ref.mesh_shape, ref.axes, ref.chips, ref.price_per_hour
        )
        assert s.hw.__dict__ == ref.hw.__dict__
    h100 = [s for s in core.CATALOG if s.hw is core.H100]
    assert [(s.name, s.chips) for s in h100] == [
        ("h100-1", 1), ("h100-2", 2), ("h100-4", 4), ("h100-8", 8)
    ]
    hw = core.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.hbm_per_chip) == (989e12, 3.35e12, 450e9, 80e9)
    assert hw.price_per_chip_hour > 0
    terms = core.roofline(989e12, 3.35e12, 0.0, 1, hw)
    assert terms.t_compute == 1.0 and terms.t_memory == 1.0
    assert core.dollar_cost(3600.0, 1, 8, hw) == pytest.approx(8 * hw.price_per_chip_hour)
    with pytest.raises(ValueError, match="already registered"):
        core.register_shape(core.CloudShape("h100-1", (1, 1), ("data", "model"), hw))


def test_cost_functions_and_configs_match_reference():
    for args in [(64, 512, 1024), (1024, 8192, 65536)]:
        assert service.service_flops_bytes(*args) == jservice.service_flops_bytes(*args)
        assert service.service_collective_bytes(*args[::2]) == jservice.service_collective_bytes(
            *args[::2]
        )
    for name in ("TRAINING_GRID", "SURVEILLANCE_GRID_64", "SURVEILLANCE_GRID_1024"):
        assert getattr(mset_paper, name) == getattr(jax_mset_paper, name)
    for name in ("CUSTOMER_A", "CUSTOMER_B"):
        case, ref = getattr(mset_paper, name), getattr(jax_mset_paper, name)
        assert (case.__dict__, case.valid()) == (ref.__dict__, ref.valid())
    assert core.mfu(1e12, 1.0, 4, core.V5E) == jcost.mfu(1e12, 1.0, 4, jcost.V5E)


# ------------------------------ isolation and devices ----------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = ROOT / "src" / "repro_torch"
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(pkg).with_suffix("").parts).removesuffix(
            ".__init__"
        )
        for p in pkg.rglob("*.py")
    )
    assert "repro_torch.kernels.similarity.similarity" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(len(bad), bad[:5])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = TPSSParams(n_signals=2, n_obs=8)
    z = np.zeros((2, 2), np.float32)
    calls = [
        lambda: synthesize(0, p),
        lambda: draw(0, p),
        lambda: scope.mset_workload(),
        lambda: scope.mset_workload(split=scope.surveillance_split),
        lambda: scope.run_mset("small", reps=1, verbose=False),
        lambda: MSETModel.from_numpy(z, z, z[0], z[0], 1.0, "gaussian"),
        lambda: Model(get_config("minitron-4b", smoke=True)),
        lambda: build_model(get_config("minitron-4b", smoke=True)),
        lambda: generate("minitron-4b"),
        lambda: Model.from_numpy(get_config("minitron-4b", smoke=True), {}),
        lambda: StepBuilder(get_config("mamba2-130m", smoke=True)),
        lambda: TokenPipeline(512, 16, 2).batch(0),
        lambda: train_lm(TrainJob("mamba2-130m", steps=1, ckpt_dir=str(tmp_path)), verbose=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert synthesize(0, p, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
