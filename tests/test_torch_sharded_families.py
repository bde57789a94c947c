"""The SSM (mamba2) and enc-dec (seamless) families' sharded steps on a threaded world
of 8 CPU ranks against the port's unsharded steps, within 1e-5 (helpers and tolerance
in ``tests/torch_sharded_cases.py``; the dense and MoE families are in
``tests/test_torch_sharded.py``): both at (2, 4), and mamba2 smoke with 4 SSM heads (head dim 32)
at (1, 8), where the heads do not divide the ``model`` axis and stay whole on every
rank.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_sharded_cases
from torch_sharded_cases import close, world

WORLD_NAMES = ("2x4-families", "1x8-families")

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
