"""The paper's scoping example on the port (``examples/torch_scope_containers.py``)
against the JAX package's (``examples/scope_containers.py``), on the CPU.

Both files are loaded with importlib. The analytic recommendation is float64 host
arithmetic on both sides, so on the reference's catalog (the v5e shapes) the two
rankings are held equal exactly.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

from repro_torch.core import CATALOG, H100, V5E

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def examples():
    port = _load("torch_scope_containers", "examples/torch_scope_containers.py")
    ref = _load("scope_containers_reference", "examples/scope_containers.py")
    return port, ref


CUSTOMERS = [("CUSTOMER_A", 1 / 3600, 1), ("CUSTOMER_B", 1.0, 200)]


@pytest.mark.parametrize("customer,rate_hz,fleet", CUSTOMERS)
def test_v5e_ranking_equals_the_reference_example(examples, customer, rate_hz, fleet):
    port, ref = examples
    from repro.configs import mset_paper as jax_mset_paper
    from repro_torch.configs import mset_paper

    v5e = [s for s in CATALOG if s.hw is V5E]
    got = port.analytic_recommendation(getattr(mset_paper, customer), rate_hz, fleet, shapes=v5e)
    want = ref.analytic_recommendation(getattr(jax_mset_paper, customer), rate_hz, fleet)
    assert got.ranking == want.ranking
    assert got.shape.name == want.shape.name and got.t_step == want.t_step
    assert got.reason == want.reason


def test_the_port_keeps_the_reference_helpers(examples):
    port, _ = examples
    from benchmarks.common import mset_surveil_flops_bytes, tpu_roofline_time

    v5e = [s for s in CATALOG if s.hw is V5E]
    for n_sig, n_mv, n_obs in ((20, 128, 1), (75_000, 8192, 60), (64, 512, 4096)):
        fb = mset_surveil_flops_bytes(n_sig, n_mv, n_obs)
        assert port.mset_surveil_flops_bytes(n_sig, n_mv, n_obs) == fb
        for shape in v5e:
            assert port.roofline_time(*fb, shape) == tpu_roofline_time(*fb, chips=shape.chips)


def test_h100_shapes_are_rated_on_h100(examples):
    port, _ = examples
    rec = port.analytic_recommendation(port.CUSTOMER_A, 1 / 3600)
    assert {name for name, *_ in rec.ranking} == {s.name for s in CATALOG}
    f, b = port.mset_surveil_flops_bytes(20, 128, 1)
    t_of = {name: t for name, t, *_ in rec.ranking}
    for shape in (s for s in CATALOG if s.hw is H100):
        want = max(f / (shape.chips * H100.peak_flops), b / (shape.chips * H100.hbm_bw))
        assert t_of[shape.name] == want


def test_measured_scoping_on_the_cpu_gives_a_finite_surface(examples):
    port, _ = examples
    grid = {"n_signals": [4, 8], "n_memvec": [16, 32]}
    surf = port.measured_scoping("cpu", grid=grid, reps=1)
    assert np.isfinite(surf.r2)
    for params in ({"n_signals": 4, "n_memvec": 16}, {"n_signals": 8, "n_memvec": 32}):
        t = surf.predict(params)
        assert np.isfinite(t) and t > 0
