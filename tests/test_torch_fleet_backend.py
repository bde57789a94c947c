"""The port's compiled fleet backend (``backend="torch"``) on the CPU, held
against the port's own numpy path.

The JAX package's compiled backend does not run on this jax (its
``enable_x64`` import is gone), so ``torchsim`` is held against the numpy
engine that the JAX package's own tests pinned its compiled path to: the bar of
``tests/test_jax_backend.py``'s ``_assert_equivalent`` on the coarse core, and
bit for bit on the substep core, as ``tests/test_substep.py`` demands. The same
scenarios run on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fleet import (
    PredictivePolicy,
    QueueProportionalPolicy,
    StaticPolicy,
    make_kernel,
    poisson_trace,
    simulate,
    simulate_fleet,
    telemetry,
    tiered_sla_workload,
)
from repro_torch.fleet import kernels, torchsim
from torch_fleet_cases import (
    DISCIPLINES,
    FAMILIES,
    GOLDEN,
    SUBSTEP_GRID,
    assert_bitexact,
    assert_equivalent,
    check_forecaster,
    check_kernel_steps,
    check_lattice,
    families,
    fidelity_run,
    flash_slate,
    service,
    substep_run,
)

CPU = dict(backend="torch", device="cpu")


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_scenario_matches_numpy(name):
    a, b = GOLDEN[name](), GOLDEN[name](**CPU)
    assert_equivalent(a, b)
    if name == "predictive-admission":
        assert b.dropped.sum() > 0  # the queue bound bound


def test_backends_agree_property():
    """``tests/test_jax_backend.py``'s property, at its coarse bar on every field:
    random seeds, disciplines, cold-start jitter, load and knobs."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    svc = service()

    @settings(max_examples=5, deadline=None, database=None)
    @given(
        seed=st.integers(min_value=0, max_value=1000),
        disc=st.sampled_from(DISCIPLINES),
        jitter=st.floats(min_value=0.0, max_value=0.8),
        rate_mult=st.floats(min_value=1.0, max_value=6.0),
        drain_s=st.floats(min_value=5.0, max_value=90.0),
        headroom=st.floats(min_value=0.6, max_value=0.95),
    )
    def prop(seed, disc, jitter, rate_mult, drain_s, headroom):
        wl = tiered_sla_workload(
            rate_mult * svc.max_throughput, 600.0, dt_s=5.0, n_seeds=3, seed=seed
        )
        kw = dict(cold_start_s=(30.0, jitter), discipline=disc, cold_start_seed=seed)
        a = simulate(wl, svc, QueueProportionalPolicy(drain_s, headroom), **kw)
        b = simulate(wl, svc, QueueProportionalPolicy(drain_s, headroom), **CPU, **kw)
        assert_equivalent(a, b)

    prop()


@pytest.mark.parametrize("disc", DISCIPLINES)
@pytest.mark.parametrize("n_substeps,preemptive", SUBSTEP_GRID)
def test_substep_backends_bit_exact(disc, n_substeps, preemptive):
    a = substep_run(disc, n_substeps, preemptive)
    b = substep_run(disc, n_substeps, preemptive, **CPU)
    assert_bitexact(a, b, f"{disc} n={n_substeps} pre={preemptive}")


@pytest.mark.parametrize("disc", DISCIPLINES)
def test_n1_nonpreemptive_is_the_coarse_core(disc):
    pinned = substep_run(disc, 1, False, **CPU)
    a = substep_run(disc, 1, False)
    assert_equivalent(a, pinned)
    assert pinned.preemptions is None and pinned.residue_work is None


def test_preemption_really_happens_on_the_fidelity_case():
    a, b = fidelity_run(), fidelity_run(**CPU)
    assert_bitexact(a, b, "fidelity")
    assert b.preemptions.sum() > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_policy_kernel_steps_match_numpy_policy(family):
    check_kernel_steps(family, torch.device("cpu"))


def test_every_family_has_a_cached_kernel():
    fams, classes = families()
    for family, (fleet, make) in fams.items():
        k = make_kernel(make(), fleet, classes)
        assert isinstance(k, kernels.PolicyKernel)
        assert make_kernel(make(), fleet, classes) is k
        assert set(k.params_of(make())) == set(k.param_names)
    assert make_kernel(_CustomPolicy(4), fams["static"][0], classes) is None


def test_seq_sum0_adds_left_to_right_like_numpy():
    rng = np.random.default_rng(0)
    for shape in ((20, 3), (48, 2, 5), (9, 1, 1), (30,)):
        x = rng.random(shape) * np.exp(rng.normal(0, 6, shape))
        want = x[0].copy()
        for row in x[1:]:
            want = want + row
        assert np.array_equal(kernels.seq_sum0(torch.from_numpy(x)).numpy(), want)
        if x.ndim == 2:  # numpy's own axis-0 sum of a multi-column array
            assert np.array_equal(x.sum(axis=0), want)
    a = torch.tensor([1.0, 7.0, 0.1], dtype=torch.float64)
    assert torch.equal(kernels.div(a, 3.0), a / torch.tensor(3.0, dtype=torch.float64))


def test_lattice_equals_the_sequential_loop_and_tiles():
    check_lattice(torch.device("cpu"))


def test_lattice_pads_to_a_power_of_two_and_counts_tiles():
    wl, fleet, params, ctx = flash_slate(n=5, n_seeds=2, duration=60.0)
    pols = [PredictivePolicy.from_params(p, **ctx) for p in params]
    kernel, kw = torchsim.slate_arguments(wl, fleet, pols)
    with telemetry.session() as tel:
        torchsim.run_dynamics(kernel, **kw, device="cpu")
        torchsim.run_dynamics(kernel, **kw, tile=2, device="cpu")
    spans = [s for s in tel.tracer.roots if s.name == "torchsim.dispatch"]
    assert [s.attrs["padded"] for s in spans] == [8, 2, 2, 2]
    assert [s.attrs.get("tile") for s in spans] == [None, 0, 1, 2]
    assert tel.metrics.get("torchsim_tiles_total").value == 3


def test_substep_lattice_equals_numpy_bit_for_bit():
    wl, fleet, params, ctx = flash_slate(n=3, n_seeds=2, duration=300.0)
    pols = [PredictivePolicy.from_params(p, **ctx) for p in params]
    kernel, kw = torchsim.slate_arguments(wl, fleet, pols, discipline="edf")
    sub = dict(n_substeps=4, preemptive=True)
    out = torchsim.run_dynamics(kernel, **kw, **sub, device="cpu")
    sims = torchsim.slate_results(wl, fleet, pols, out, discipline="edf", **sub)
    for p, sim in zip(params, sims):
        pol = PredictivePolicy.from_params(p, **ctx)
        assert_bitexact(simulate_fleet(wl, fleet, pol, discipline="edf", **sub), sim, str(p))


def test_slate_refuses_mixed_families():
    wl, fleet, params, ctx = flash_slate(n=2, duration=60.0)
    pols = [PredictivePolicy.from_params(params[0], **ctx), QueueProportionalPolicy()]
    with pytest.raises(ValueError, match="one policy family"):
        torchsim.slate_arguments(wl, fleet, pols)


# ---------------------------- the backend contract ----------------------------


class _CustomPolicy(StaticPolicy):
    """A user-defined subclass: no compiled kernel."""

    name = "custom"


def _trace():
    return poisson_trace(2 * service().max_throughput, 300.0, dt_s=5.0, n_seeds=2)


def test_auto_runs_custom_policies_on_numpy_and_torch_raises():
    svc, tr = service(), _trace()
    a = simulate(tr, svc, _CustomPolicy(4), slo_s=2.0, backend="auto")
    b = simulate(tr, svc, _CustomPolicy(4), slo_s=2.0, backend="numpy")
    np.testing.assert_array_equal(a.served, b.served)
    with pytest.raises(ValueError, match="no compiled kernel"):
        simulate(tr, svc, _CustomPolicy(4), slo_s=2.0, **CPU)
    with pytest.raises(ValueError, match="backend"):
        simulate(tr, svc, StaticPolicy(4), slo_s=2.0, backend="jax")


def test_auto_picks_torch_for_a_builtin_family():
    with telemetry.session() as tel:
        simulate(_trace(), service(), StaticPolicy(4), slo_s=2.0, backend="auto", device="cpu")
    assert [s.name for s in tel.tracer.roots] == ["torchsim.dispatch"]


def test_no_card_no_hidden_cpu(monkeypatch):
    """With no card, ``device=None`` raises: nothing runs the torch backend on
    the CPU unasked, and nothing falls back to numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc, tr = service(), _trace()
    for backend in ("torch", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            simulate(tr, svc, StaticPolicy(4), slo_s=2.0, backend=backend)
    # a family with no kernel stays on numpy under auto, card or not
    simulate(tr, svc, _CustomPolicy(4), slo_s=2.0, backend="auto")


def test_dispatch_span_and_counters():
    svc = service()
    tr = poisson_trace(2 * svc.max_throughput, 100.0, dt_s=5.0, n_seeds=2, seed=5)
    torchsim._DISPATCHED.clear()
    with telemetry.session() as tel:
        for _ in range(2):
            simulate(tr, svc, StaticPolicy(3), slo_s=2.0, **CPU)
    kinds = [s.attrs["kind"] for s in tel.tracer.roots if s.name == "torchsim.dispatch"]
    assert kinds == ["cold", "warm"]
    assert tel.metrics.get("torchsim_dispatch_total", kind="cold").value == 1
    assert tel.metrics.get("torchsim_dispatch_total", kind="warm").value == 1
    assert tel.metrics.get("torchsim_dispatch_seconds_total", kind="warm").value > 0


def test_forecaster_matches_numpy_value_for_value():
    check_forecaster(torch.device("cpu"))


def test_one_seed_windows_are_summed_pairwise_by_numpy():
    """With one seed a forecast window is one contiguous column, which numpy sums
    pairwise (eight lanes, a tree, the rest in order; halved past 128 elements);
    the kernels' window sum reproduces that order for every window length, each
    candidate with its own. With two or more seeds numpy adds rows left to right."""
    rng = np.random.default_rng(0)
    for W in (5, 8, 20, 48, 129, 240):
        age = kernels._ages(W, "cpu")
        for S in (1, 2):
            x = rng.random((W, 6, S)) * np.exp(rng.normal(0, 6, (W, 6, S)))
            for _ in range(8):
                w = rng.integers(1, W + 1, (6, 1)).astype(float)
                got = kernels._window_sum(torch.from_numpy(x), age, torch.from_numpy(w))
                for i in range(6):
                    H = np.ascontiguousarray(x[W - int(w[i, 0]):, i, :])
                    assert np.array_equal(got[i].numpy(), H.sum(axis=0)), (W, S, w[i, 0])
