"""The port's MSET2, memory vectors, SPRT and plugins against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages as numpy.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax.numpy as jnp
import numpy as np

from repro.kernels.similarity import similarity_ref as jax_similarity_ref
from repro.mset import mset2 as jmset2
from repro.mset import pluggable as jpluggable
from repro.mset.sprt import SPRTParams as JaxSPRTParams
from repro.mset.sprt import empirical_false_alarm_rate as jax_false_alarm_rate
from repro.mset.sprt import sprt as jax_sprt
from repro.mset.memory_vectors import select_memory_vectors as jax_select
from repro_torch.kernels import similarity_ref
from repro_torch.mset import (
    REGISTRY,
    MSETModel,
    SPRTParams,
    empirical_false_alarm_rate,
    estimate,
    get_plugin,
    sprt,
    train,
)
from repro_torch.mset import mset2
from repro_torch.mset.memory_vectors import equidistant_take, select_memory_vectors
from torch_parity_data import WELL_POSED, telemetry

EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _reference_case(seed, n_signals, n_obs, n_memvec):
    """Telemetry and the JAX package's model trained on its first 75%."""
    X = telemetry(seed, n_obs, n_signals)
    n_tr = n_obs * 3 // 4
    return X, n_tr, jmset2.train(jnp.asarray(X[:n_tr]), n_memvec, impl="ref")


# ------------------------------ memory vectors -----------------------------


@pytest.mark.parametrize("n_obs", [100, 257, 1000, 3072, 4096, 12288, 16384, 40000, 65536])
def test_equidistant_take_matches_jnp_linspace_truncation(n_obs):
    for m in [0, 1, 2, 3, 7, 64, 100, 1000, 1024, 4096, 8192]:
        if m > n_obs:
            continue
        ref = np.asarray(jnp.linspace(0, n_obs - 1, m).astype(jnp.int32))
        np.testing.assert_array_equal(equidistant_take(n_obs, m).numpy(), ref)


@pytest.mark.parametrize(
    "n_obs,n_memvec,n_signals",
    [(65536, 4096, 2), (16384, 8192, 4), (3072, 1024, 8), (4096, 128, 32), (1000, 7, 3)],
)
def test_memory_vector_indices_equal(n_obs, n_memvec, n_signals):
    # Integer-valued data: squared norms are exact in float32 whatever the order of
    # summation, so the stable sort and the argmin/argmax ties are what is tested.
    rng = np.random.default_rng(n_obs + n_memvec)
    X = rng.integers(-40, 40, (n_obs, n_signals)).astype(np.float32)
    ref = np.asarray(jax_select(jnp.asarray(X), n_memvec))
    out = select_memory_vectors(_t(X), n_memvec).numpy()
    np.testing.assert_array_equal(out, ref)


# ------------------------------ MSET2 --------------------------------------


@pytest.mark.parametrize("m,n", [(64, 8), (300, 16)])
def test_bandwidth_matches(m, n):
    D = np.random.default_rng(m).standard_normal((m, n)).astype(np.float32)
    ref = float(jmset2._bandwidth(jnp.asarray(D)))
    assert float(mset2._bandwidth(_t(D))) == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("seed,n_signals,n_obs,n_memvec", WELL_POSED)
def test_train_similarity_matrix_matches(seed, n_signals, n_obs, n_memvec):
    X, n_tr, jm = _reference_case(seed, n_signals, n_obs, n_memvec)
    tm = train(_t(X[:n_tr]), n_memvec)
    assert tm.gamma == pytest.approx(jm.gamma, rel=1e-6)
    G_ref = np.asarray(jax_similarity_ref(jm.D, jm.D, jm.gamma))
    G = similarity_ref(tm.D, tm.D, tm.gamma).numpy()
    off = ~np.eye(n_memvec, dtype=bool)
    np.testing.assert_allclose(G[off], G_ref[off], atol=5e-6, rtol=5e-6)
    # Diagonal: d2 = |x|^2 + |x|^2 - 2 x.x cancels to ~0 with rounding of order
    # n * eps * max|x|^2 in each package, which the square root amplifies.
    sq = float((np.asarray(jm.D, np.float64) ** 2).sum(1).max())
    bound = np.sqrt(4 * n_signals * EPS32 * sq) / jm.gamma
    assert np.abs(np.diag(G) - np.diag(G_ref)).max() <= bound


@pytest.mark.parametrize("seed,n_signals,n_obs,n_memvec", WELL_POSED)
def test_pseudo_inverse_matches_on_the_same_G(seed, n_signals, n_obs, n_memvec):
    _, _, jm = _reference_case(seed, n_signals, n_obs, n_memvec)
    G = np.asarray(jax_similarity_ref(jm.D, jm.D, jm.gamma))
    Gi = mset2.regularized_pinv(_t(G), 1e-6).numpy()
    Gr = (G.astype(np.float64) + G.T) / 2 + 1e-6 * np.eye(n_memvec)
    exact = np.linalg.inv(Gr)
    ev = np.linalg.eigvalsh(Gr)
    # First-order bound of a float32 eigendecomposition: backward error m*eps*|G|,
    # amplified by |Ginv|^2. The reference's own error against float64 is added, as
    # its float32 eigh on the CPU is at some sizes far less accurate than that.
    bound = n_memvec * EPS32 * ev[-1] / ev[0] ** 2
    assert np.abs(Gi - exact).max() <= bound
    ref_err = np.abs(np.asarray(jm.Ginv) - exact).max()
    assert np.abs(Gi - np.asarray(jm.Ginv)).max() <= ref_err + bound


@pytest.mark.parametrize("seed,n_signals,n_obs,n_memvec", WELL_POSED)
def test_carried_model_estimates_as_the_reference(seed, n_signals, n_obs, n_memvec):
    X, n_tr, jm = _reference_case(seed, n_signals, n_obs, n_memvec)
    model = MSETModel.from_numpy(jm.D, jm.Ginv, jm.mean, jm.std, jm.gamma, jm.kind, device="cpu")
    xhat_ref, res_ref = jmset2.estimate(jm, jnp.asarray(X[n_tr:]), impl="ref")
    xhat, res = estimate(model, _t(X[n_tr:]))
    # Same model: only float32 rounding of K, W and x_hat summed in another order.
    tol = 1e-5 * np.abs(X).max()
    np.testing.assert_allclose(xhat.numpy(), np.asarray(xhat_ref), atol=tol, rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), atol=tol, rtol=0)
    back = model.to_numpy()
    for k in ("D", "Ginv", "mean", "std"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jm, k)))
    assert (back["gamma"], back["kind"]) == (jm.gamma, jm.kind)
    assert set(dict(model.named_buffers())) == {"D", "Ginv", "mean", "std"}


def test_step_hook_sees_each_step_and_changes_nothing():
    seed, n_signals, n_obs, n_memvec = WELL_POSED[0]
    X = _t(telemetry(seed, n_obs, n_signals))
    n_tr = n_obs * 3 // 4
    seen = []

    def step(name, fn):
        seen.append(name)
        return fn()

    model = train(X[:n_tr], n_memvec, step=step)
    _, res = estimate(model, X[n_tr:], step=step)
    assert seen == [
        "memory vectors",
        "bandwidth",
        "similarity D x D",
        "eigh pseudo-inverse",
        "similarity D x X",
        "Ginv K",
        "W^T D",
    ]
    plain = train(X[:n_tr], n_memvec)
    assert torch.equal(model.Ginv, plain.Ginv)
    assert torch.equal(res, estimate(plain, X[n_tr:])[1])


def test_repeated_memory_vectors_put_eigenvalues_at_the_cut():
    """A fault of the reference that the port keeps (ROADMAP, R3).

    When one observation is the extreme of two signals, or an ordered sample repeats
    an envelope vector, D repeats a row and G is singular. G + reg*I then has an
    eigenvalue at reg itself, and ``evals > reg`` keeps or drops it on rounding
    noise, in either package, so Ginv is not comparable between them.
    """
    X = telemetry(0, 512, 4)
    n_memvec, reg = 32, 1e-6
    jm = jmset2.train(jnp.asarray(X), n_memvec, reg=reg, impl="ref")
    tm = train(_t(X), n_memvec, reg=reg)
    D = tm.D.numpy()
    repeats = n_memvec - len(np.unique(D, axis=0))
    assert repeats >= 1
    for G in (
        np.asarray(jax_similarity_ref(jm.D, jm.D, jm.gamma)),
        similarity_ref(tm.D, tm.D, tm.gamma).numpy(),
    ):
        ev = np.linalg.eigvalsh((G.astype(np.float64) + G.T) / 2 + reg * np.eye(n_memvec))
        noise = n_memvec * EPS32 * ev[-1]
        assert int(np.sum(np.abs(ev - reg) < noise)) >= repeats
    _, res = estimate(tm, _t(X))
    assert bool(torch.isfinite(res).all())


# ------------------------------ SPRT ---------------------------------------


@pytest.mark.parametrize(
    "alpha,beta,m_shift", [(1e-3, 1e-3, 3.0), (1e-2, 1e-3, 4.0), (0.05, 0.1, 2.0)]
)
def test_sprt_alarms_equal(alpha, beta, m_shift):
    rng = np.random.default_rng(int(m_shift * 10))
    r = rng.standard_normal((3000, 6)).astype(np.float32)
    r[1500:, 2] += 3.0
    r[2000:, 4] -= 2.5
    sigma = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    mu = rng.uniform(-0.1, 0.1, 6).astype(np.float32)
    jp = JaxSPRTParams(alpha, beta, m_shift)
    p = SPRTParams(alpha, beta, m_shift)
    assert (p.upper, p.lower) == (jp.upper, jp.lower)
    a_ref, sp_ref, sn_ref = jax_sprt(jnp.asarray(r), jnp.asarray(sigma), jp, mu=jnp.asarray(mu))
    a, sp, sn = sprt(_t(r), _t(sigma), p, mu=_t(mu))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sp_ref), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(sn.numpy(), np.asarray(sn_ref), atol=1e-4, rtol=1e-5)
    assert a.numpy()[1500:, 2].any()


def test_sprt_false_alarm_rate_matches():
    r = np.random.default_rng(1).standard_normal((5000, 4)).astype(np.float32)
    a_ref, _, _ = jax_sprt(jnp.asarray(r), jnp.ones(4), JaxSPRTParams(m_shift=4.0))
    a, _, _ = sprt(_t(r), torch.ones(4), SPRTParams(m_shift=4.0))
    far = float(jax_false_alarm_rate(a_ref))
    assert float(empirical_false_alarm_rate(a)) == far
    assert far < 5e-3


# ------------------------------ plugins ------------------------------------


@pytest.mark.parametrize("name", ["aakr", "ridge"])
@pytest.mark.parametrize("seed,n_signals,n_obs,n_memvec", WELL_POSED[:2])
def test_plugins_match_reference(name, seed, n_signals, n_obs, n_memvec):
    X = telemetry(seed, n_obs, n_signals)
    n_tr = n_obs * 3 // 4
    jplug, plug = jpluggable.get_plugin(name), get_plugin(name)
    jmodel = jplug.train(jnp.asarray(X[:n_tr]), n_memvec)
    xhat_ref, _ = jplug.estimate(jmodel, jnp.asarray(X[n_tr:]))
    xhat, res = plug.estimate(plug.train(_t(X[:n_tr]), n_memvec), _t(X[n_tr:]))
    # standardization, K and the solve round in another order: float32 level of |X|
    tol = 1e-5 * np.abs(X).max()
    np.testing.assert_allclose(xhat.numpy(), np.asarray(xhat_ref), atol=tol, rtol=0)
    np.testing.assert_allclose(res.numpy(), X[n_tr:] - xhat.numpy(), atol=1e-6)


def test_registry_names_match():
    assert list(REGISTRY) == list(jpluggable.REGISTRY)
