"""The port's slice on the card, held against its own plain (CPU) path.

Every test here needs a CUDA card and skips without one; none imports JAX, so
they run on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.launch import scope
from repro_torch.mset import SPRTParams, estimate, sprt, train
from repro_torch.tpss import TPSSParams, synthesize
from torch_parity_data import WELL_POSED, telemetry

pytestmark = pytest.mark.gpu
sim_module = importlib.import_module("repro_torch.kernels.similarity.similarity")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_main_path_launches_the_kernel(cuda):
    sim_module.launches = 0
    grid = {"n_signals": [8, 16], "n_memvec": [32, 64], "n_observations": [512]}
    res, surf = scope.run_mset(grid, reps=1, device=cuda, verbose=False)
    assert len(res.rows) == 4 and np.isfinite(surf.r2)
    # one sim(D, D) and one sim(D, X) for each of warm-up + 1 rep, in each cell
    assert sim_module.launches == 4 * 2 * 2


def test_mset2_on_the_card_matches_the_cpu(cuda):
    seed, n_signals, n_obs, n_memvec = WELL_POSED[2]
    X = torch.from_numpy(telemetry(seed, n_obs, n_signals))
    n_tr = n_obs * 3 // 4
    cpu_model = train(X[:n_tr], n_memvec=n_memvec)
    _, r_cpu = estimate(cpu_model, X[n_tr:])
    model = train(X[:n_tr].to(cuda), n_memvec=n_memvec)
    _, r = estimate(model, X[n_tr:].to(cuda))
    assert r.is_cuda and model.Ginv.is_cuda
    # the same bar as the CPU parity with the JAX package (tests/test_torch_slice.py)
    tol = 1e-3 * float(X.abs().max())
    np.testing.assert_allclose(r.cpu().numpy(), r_cpu.numpy(), atol=tol, rtol=0)


def test_sprt_on_the_card_gives_the_cpu_alarms(cuda):
    rng = np.random.default_rng(2)
    r = rng.standard_normal((2000, 8)).astype(np.float32)
    r[1000:, 3] += 3.0
    r = torch.from_numpy(r)
    sigma = torch.ones(8)
    a_cpu, sp_cpu, _ = sprt(r, sigma, SPRTParams())
    a, sp, _ = sprt(r.to(cuda), sigma.to(cuda), SPRTParams())
    assert torch.equal(a.cpu(), a_cpu)
    np.testing.assert_allclose(sp.cpu().numpy(), sp_cpu.numpy(), atol=1e-5, rtol=1e-6)


def test_synthesis_on_the_card(cuda):
    p = TPSSParams(n_signals=16, n_obs=1024)
    a, b = synthesize(5, p, device=cuda), synthesize(5, p, device=cuda)
    assert a.is_cuda and a.shape == (1024, 16)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
