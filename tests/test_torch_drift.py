"""The port's drift probe (``repro_torch.fleet.telemetry.drift``) against ``repro``'s
on ``tests/test_telemetry.py``'s ``drift_setup`` world and ``tests/test_control.py``'s
fresh seeds, on the CPU.

The probe's baseline has two constant columns and repeated memory vectors, so its
G is singular and Ginv is decided by rounding in either package (ROADMAP R7). The
bar is therefore held three ways: the reference's fitted model carried across
(residuals within the float32 rounding of Ginv K); the port's SPRT stage fed the
reference's residuals (the whole report equal); and each package training its own
probe (the verdicts equal).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import dataclasses

import numpy as np

import repro.core as r_core
import repro.fleet as r_fleet
import repro.mset as r_mset
import repro_torch.core as t_core
import repro_torch.fleet as t_fleet
import repro_torch.mset as t_mset
from repro.fleet.telemetry import drift as r_drift
from repro.kernels.similarity import similarity as r_similarity
from repro_torch.fleet.telemetry import drift as t_drift
from repro_torch.kernels.similarity import similarity as t_similarity
from repro_torch.mset.memory_vectors import select_memory_vectors as t_select

import torch_control_cases as cc

REF = (r_core, r_fleet)
PORT = (t_core, t_fleet)
EPS32 = float(np.finfo(np.float32).eps)
WINDOWS = ("fresh-7", "degraded-1.3", "raw-11")


@pytest.fixture(scope="module")
def probes():
    """Each package's probe fitted on its own run of the baseline (seed 0), the
    port's on the CPU, and both packages' observation windows."""
    _, r_run = cc.drift_world(REF)
    _, t_run = cc.drift_world(PORT)
    r_base, t_base = r_run(0), t_run(0)
    return dict(
        ref=r_drift.DriftProbe().fit(r_base),
        port=t_drift.DriftProbe(device="cpu").fit(t_base),
        r_base=r_base,
        t_base=t_base,
        r_win=cc.drift_windows(REF),
        t_win=cc.drift_windows(PORT),
    )


def carried(ref_probe):
    """A port probe holding the reference probe's fitted model, mu and sigma."""
    m = ref_probe.model
    arrays = [np.asarray(a) for a in (m.D, m.Ginv, m.mean, m.std)]
    model = t_mset.MSETModel.from_numpy(*arrays, m.gamma, m.kind, device="cpu")
    return dataclasses.replace(
        t_drift.DriftProbe(device="cpu"), model=model, mu=ref_probe.mu, sigma=ref_probe.sigma
    )


def report_fields(rep):
    return dataclasses.asdict(rep)


def test_drift_names_equal():
    import repro.fleet.telemetry as r_tel
    import repro_torch.fleet.telemetry as t_tel

    assert t_tel._LAZY == r_tel._LAZY
    assert t_tel.__all__ == r_tel.__all__
    for name in t_tel._LAZY:
        assert getattr(t_tel, name) is not None
    assert t_tel.drift is t_drift


def test_telemetry_matrix_and_degrade_fleet_bit_for_bit(probes):
    for sig in (t_drift.DEFAULT_SIGNALS, ("arrival_rate", "replicas")):
        want = r_drift.telemetry_matrix(probes["r_base"], sig)
        got = t_drift.telemetry_matrix(probes["t_base"], sig)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown drift signal"):
        t_drift.telemetry_matrix(probes["t_base"], ("bogus",))
    r_fl, _ = cc.drift_world(REF)
    t_fl, _ = cc.drift_world(PORT)
    for f in (1.0, 1.3, 2.0):
        a = r_drift.degrade_fleet(r_fl, f).pools[0].service
        b = t_drift.degrade_fleet(t_fl, f).pools[0].service
        assert (a.t_fixed, a.t_per_unit) == (b.t_fixed, b.t_per_unit)


def test_memory_vector_indices_equal(probes):
    """The memory vectors each package's ``train`` picks from the fit rows, each
    standardizing them its own way (the means differ by an ulp, R7), and the port's
    on the reference's standardized rows."""
    import jax.numpy as jnp
    from repro.mset.memory_vectors import select_memory_vectors as r_select

    X = r_drift.telemetry_matrix(probes["r_base"])[0::2].astype(np.float32)
    Xj = jnp.asarray(X)
    Xs_r = (Xj - jnp.mean(Xj, axis=0)) / (jnp.std(Xj, axis=0) + 1e-6)
    Xt = torch.as_tensor(X)
    Xs_t = (Xt - Xt.mean(0)) / (Xt.std(0, correction=0) + 1e-6)
    want = np.asarray(r_select(Xs_r, 48))
    assert np.array_equal(t_select(Xs_t, 48).numpy(), want)
    assert np.array_equal(t_select(torch.as_tensor(np.array(Xs_r)), 48).numpy(), want)


def test_r7_baseline_has_constant_columns_and_repeated_memory_vectors(probes):
    """ROADMAP R7: on ``drift_setup``'s baseline two of the three monitored columns
    are constant and 4 of the 48 memory vectors repeat, so G is singular (an
    eigenvalue within reg of 0) and Ginv is decided by rounding, differently in
    the two packages; the calibrated sigma of ``utilization`` differs with it."""
    X = r_drift.telemetry_matrix(probes["r_base"])
    assert [len(np.unique(X[:, j])) for j in range(3)] == [1, 346, 1]
    for D in (np.asarray(probes["ref"].model.D), probes["port"].model.D.numpy()):
        assert D.shape == (48, 3) and len(np.unique(D, axis=0)) == 44
    r_ginv = np.abs(np.asarray(probes["ref"].model.Ginv)).max()
    t_ginv = np.abs(probes["port"].model.Ginv.numpy()).max()
    assert r_ginv > 1e5 and t_ginv > 1e5 and abs(r_ginv - t_ginv) > 1e4
    assert probes["ref"].sigma[1] != probes["port"].sigma[1]
    model = probes["port"].model
    G = t_similarity(model.D, model.D, gamma=model.gamma)
    assert float(torch.linalg.eigvalsh(G.double()).min()) < 1e-6


@pytest.mark.parametrize("window", WINDOWS)
def test_carried_model_residuals_within_float32_bound(probes, window):
    """With the reference's fitted model carried across, the port's residuals are
    within the first-order float32 bound of W = Ginv K and x_hat = W^T D from those
    of ``repro``: each package's K (its own similarity, compared as computed), then
    gamma_m |Ginv| |K| for each package's product order, carried through |D| and the
    standardization."""
    ref = probes["ref"]
    m = ref.model
    X = probes["r_win"][window]
    X = X if isinstance(X, np.ndarray) else r_drift.telemetry_matrix(X)
    _, r_res = r_mset.estimate(m, X)
    t_model = carried(ref).model
    _, t_res = t_mset.estimate(t_model, torch.as_tensor(X.astype(np.float32)))
    r_res, t_res = np.asarray(r_res, np.float64), t_res.numpy().astype(np.float64)

    D, Ginv = np.asarray(m.D, np.float64), np.asarray(m.Ginv, np.float64)
    mean, std = np.asarray(m.mean, np.float64), np.asarray(m.std, np.float64)
    Xs = (X.astype(np.float32) - np.asarray(m.mean)) / np.asarray(m.std)
    K_r = np.asarray(r_similarity(m.D, Xs, gamma=m.gamma, kind=m.kind), np.float64)
    K_t = t_similarity(t_model.D, torch.as_tensor(Xs), gamma=m.gamma, kind=m.kind).numpy()
    K = np.maximum(np.abs(K_r), np.abs(K_t.astype(np.float64)))
    mm = D.shape[0]
    g = mm * EPS32 / (1 - mm * EPS32)
    dW = np.abs(Ginv) @ np.abs(K_r - K_t) + 2 * g * (np.abs(Ginv) @ K)  # (m, T)
    W = Ginv @ K_r
    dXs = dW.T @ np.abs(D) + 2 * g * (np.abs(W).T @ np.abs(D))  # (T, n)
    bound = std * dXs + 4 * EPS32 * (np.abs(X) + np.abs(mean) + np.abs(r_res))
    diff = np.abs(r_res - t_res)
    assert (diff <= bound).all(), float((diff / bound).max())


@pytest.mark.parametrize("window", WINDOWS)
def test_sprt_stage_on_reference_residuals_gives_the_same_report(probes, window, monkeypatch):
    """The port's SPRT stage (K3's plain loop on the CPU) fed the reference's
    residuals, mu and sigma: the DriftReport equals the reference's field by field."""
    ref = probes["ref"]
    obs = probes["r_win"][window]
    want = ref.check(obs)
    X = obs if isinstance(obs, np.ndarray) else r_drift.telemetry_matrix(obs)
    _, r_res = r_mset.estimate(ref.model, X)
    monkeypatch.setattr(
        t_drift, "estimate", lambda model, X: (None, torch.as_tensor(np.array(r_res)))
    )
    got = carried(ref).check(X)
    assert report_fields(got) == report_fields(want)


@pytest.mark.parametrize("window", WINDOWS)
def test_carried_model_end_to_end_gives_the_same_report(probes, window):
    """The reference's fitted model carried across, the port's own estimate and
    SPRT on the port's own run of the window: the whole report equal."""
    want = probes["ref"].check(probes["r_win"][window])
    got = carried(probes["ref"]).check(probes["t_win"][window])
    assert report_fields(got) == report_fields(want)


@pytest.mark.parametrize("window", WINDOWS)
def test_own_probes_agree_on_the_verdict(probes, window):
    """Each package trains its own probe: the verdicts agree on every window, and the
    first alarm bin wherever the window drifted or stayed silent. On the raw seed-11
    window each probe trips once on noise (quiet verdicts), at bin 7 in ``repro`` and
    bin 5 in the port: the two Ginv decided by rounding (R7) move that one stray trip,
    and the reference's model carried across puts the port's at bin 7 too
    (``test_carried_model_end_to_end_gives_the_same_report``)."""
    want = probes["ref"].check(probes["r_win"][window])
    got = probes["port"].check(probes["t_win"][window])
    assert got.drifted == want.drifted
    assert got.n_bins == want.n_bins and got.signals == want.signals
    if want.drifted or want.alarm_bins == 0:
        assert got.first_alarm_bin == want.first_alarm_bin
        assert got.per_signal_alarms["service_time_s"] == want.per_signal_alarms["service_time_s"]
    else:
        assert (want.first_alarm_bin, got.first_alarm_bin) == (7, 5)
        assert max(want.alarm_bins, got.alarm_bins) < probes["port"].min_alarm_bins
    if window == "degraded-1.3":
        assert (want.alarm_bins, got.alarm_bins) == (360, 360) and want.first_alarm_bin == 0


def test_fresh_seeds_stay_quiet_in_both():
    """``test_control.py``'s false-alarm case: each package's probe, fitted on a
    StaticPolicy run, on seven fresh seeds: the same verdicts and first alarm bins."""
    out = {}
    for name, pkg, dev in (("ref", REF, {}), ("port", PORT, {"device": "cpu"})):
        fm = pkg[1]
        wl, svc = cc.control_workload(pkg, n_seeds=4)
        fl = cc.fleet(pkg, svc)
        probe = fm.telemetry.DriftProbe(**dev).fit(fm.simulate_fleet(wl, fl, fm.StaticPolicy(6)))
        reps = []
        for seed in range(7):
            fresh, _ = cc.control_workload(pkg, n_seeds=2, seed=100 + seed)
            res = fm.simulate_fleet(fresh, fl, fm.StaticPolicy(6))
            reps.append(probe.check(fm.telemetry.telemetry_matrix(res, probe.signals)))
        out[name] = [(r.drifted, r.first_alarm_bin) for r in reps]
    assert out["port"] == out["ref"]
    assert not any(d for d, _ in out["port"])


def test_probe_emits_telemetry_and_defaults_to_the_card(probes):
    with t_fleet.telemetry.session() as tel:
        rep = probes["port"].check(probes["t_win"]["raw-11"])
    assert not rep.drifted
    snap = tel.metrics.snapshot()
    assert snap["counter"]["fleet_drift_checks_total"]["verdict=ok"] == 1.0
    assert any(e["name"] == "drift_check" for e in tel.events)
    with pytest.raises(RuntimeError, match="before fit"):
        t_drift.DriftProbe(device="cpu").check(probes["t_win"]["raw-11"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_drift.DriftProbe().fit(probes["t_base"])
