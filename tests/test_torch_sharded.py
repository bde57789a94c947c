"""The port's sharded steps on a threaded world of CPU ranks against its unsharded
steps (helpers in ``tests/torch_sharded_cases.py``): the dense family at (2, 4), its
heads sharded over ``model``, and at (1, 8), where minitron smoke's 4 heads do not
divide the axis and its queries are sequence-parallel; the MoE's expert-parallel path
at (2, 4), with olmoe smoke's 8 experts and with 6, padded to 8. Each within 1e-5 of
the unsharded port (relative to the largest value, in float32); so is
``make_service``'s estimate at (2, 4). The SSM and enc-dec families are in
``tests/test_torch_sharded_families.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_sharded_cases
from repro_torch.mset import MSETModel, estimate
from repro_torch.mset.service import make_service
from torch_sharded_cases import close, full, run_world, world

WORLD_NAMES = ("2x4", "1x8")

PAIRS = torch_sharded_cases.pairs(*WORLD_NAMES)


@pytest.mark.parametrize("name,case", PAIRS)
def test_sharded_prefill_matches_the_unsharded_port(name, case):
    want, got = world(name)[case]
    close(got[0], want[0])


@pytest.mark.parametrize("name,case", PAIRS)
def test_sharded_decode_step_matches_the_unsharded_port(name, case):
    want, got = world(name)[case]
    close(got[1], want[1])


@pytest.mark.parametrize("name,case", PAIRS)
def test_sharded_grad_step_matches_the_unsharded_port(name, case):
    want, got = world(name)[case]
    close(got[2], want[2])
    assert set(got[3]) == set(want[3])
    for param in want[3]:
        try:
            close(got[3][param], want[3][param])
        except AssertionError as e:
            raise AssertionError(f"{param}: {e}") from None


def test_sharded_service_matches_the_unsharded_estimate():
    """make_service at (2, 4): D and Ginv row-sharded over model, X over data; the
    estimate and residuals against the port's ``estimate`` on the same model."""
    g = torch.Generator().manual_seed(3)
    m, n, b = 64, 8, 32
    D = torch.randn(m, n, generator=g)
    Ginv = torch.randn(m, m, generator=g) / m
    mean, std = torch.randn(n, generator=g), torch.rand(n, generator=g) + 0.5
    model = MSETModel(D, Ginv, 1.7, "inverse_distance", mean, std)
    X = torch.randn(b, n, generator=g)
    Xhat, resid = estimate(model, X)

    def work(mesh):
        est = make_service(model, mesh)
        got_hat, got_res = est(X)
        assert got_hat.placements == got_res.placements
        return full(got_hat), full(got_res)

    got_hat, got_res = run_world((2, 4), work)
    close(got_hat, Xhat)
    close(got_res, resid)
