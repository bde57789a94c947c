"""The check that decides ``correct``, driven through whole runs on the CPU at a cut
size: the port passes, the control (the reference with TF32 products in the port's
place) reads far above it, and each fault a cell can have, planted under the timed
path, fails. Where the control was read on the card at the cell's own size, its
readings and the port's are kept in ``limits/<workload>.json`` beside each limit.

A run here skips the harness's look for a card (``run.py`` makes it) and drives the
rest: set-up, warm-up, the window's loop, the check against the float64 reference and
the verdict under the cell's own limits. The faults:

* a step that returns its state unchanged: the SPRT's LLRs stay at their start (the
  surveillance cells); training leaves Ginv at zero (the scoping cell);
* half of the batch left out: ``estimate`` computes the first half of the rows and
  fills the rest with their mean;
* an answer altered where it is produced: one signal's alarms inverted (surveillance),
  one residual moved by ten of its signal's standard deviations (scoping).

The exchange between chips does not exist in a one-chip cell.
"""

from __future__ import annotations

import importlib
import json
import sys
import weakref
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from portbench import harness, reference, telemetry  # noqa: E402
from portbench.systems.mset2 import Control, Port  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
# per loop: the sizes a test run holds (the ratios of the Fig. 8 cell: m = 8 n, 2 m
# training observations) and a window long enough for the samples
CUT = {
    "stream": {"n_signals": 128, "n_memvec": 1024, "n_train": 2048, "surveil_batch": 512},
    "cells": {"n_signals": 128, "n_memvec": 1024, "n_train": 2048, "n_observations": 2048},
}
SECONDS = 0.4


@pytest.fixture(autouse=True)
def few_threads():
    """Whole runs on the CPU, kept to two threads: the suite runs files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cut(workload: str) -> harness.Cell:
    """Workload ``workload`` at the size of its loop's ``CUT``."""
    cell = harness.load_cell(workload, BENCH)
    cell.config = dict(cell.config, **CUT[cell.traffic["loop"]])
    cell.traffic = dict(cell.traffic, warmup_batches=2, warmup_cells=1, pool=2, assets=2)
    return cell


def cut_cell(loop: str) -> harness.Cell:
    return cut(next(w["name"] for w in BENCH["workloads"]
                    if harness.load_cell(w["name"], BENCH).traffic["loop"] == loop))


def verdict(loop: str, sut, seed: int = 2**32 + 17):
    run = harness.run(cut_cell(loop), seed, SECONDS, False, device="cpu", sut=sut)
    ok, shown = harness.verdict(run)
    return ok, shown


class Unchanged(Port):
    def sprt(self, r, sigma, mu):
        alarms, llr = super().sprt(r, sigma, mu)
        return torch.zeros_like(alarms), torch.zeros_like(llr)

    def train(self, X, cfg, span):
        model = super().train(X, cfg, span)
        model.Ginv.zero_()
        return model


class HalfBatch(Port):
    def estimate(self, model, X, span):
        half = X.shape[0] // 2
        r = super().estimate(model, X[:half].contiguous(), span)
        rest = r.mean(dim=0, keepdim=True).expand(X.shape[0] - half, -1)
        return torch.cat([r, rest])


class Altered(Port):
    def sprt(self, r, sigma, mu):
        alarms, llr = super().sprt(r, sigma, mu)
        alarms[:, 0] = ~alarms[:, 0]
        return alarms, llr

    def estimate(self, model, X, span):
        r = super().estimate(model, X, span)
        r[0, 0] += 10 * r[:, 0].std()
        return r


@pytest.mark.parametrize("loop", sorted(CUT))
def test_the_port_is_correct_at_a_cut_size(loop):
    ok, shown = verdict(loop, Port())
    assert ok, shown


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_drives_its_own_systems_port_correct_at_a_cut_size(workload):
    """No system handed in: the run builds the port of the system that the cell's
    configuration names, and drives it through the loop that its traffic names."""
    cell = cut(workload)
    run = harness.run(cell, 2**31 + 5, SECONDS, False, device="cpu")
    ok, shown = harness.verdict(run)
    assert ok, shown
    assert run.units > 0 and run.checks["checked"] > 0


@pytest.mark.parametrize("loop", sorted(CUT))
def test_the_control_reads_far_above_the_port(loop):
    """At a cut size the errors are smaller than at the cell's own (the card's readings
    set the limits), so the control is held to the port's readings here: ten times
    them on at least one compared number."""
    _, port = verdict(loop, Port())
    _, control = verdict(loop, Control())
    assert any(control[k]["value"] > 10 * port[k]["value"] for k in port), (port, control)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_limit_lies_between_its_readings(workload):
    """A limit lies above the highest reading of the port over a dozen seeds and below
    the lowest of the control, where that is three times the port's; the control fails
    at least one of a cell's numbers."""
    lim = harness.load_cell(workload, BENCH).limits
    failed = []
    for name, limit in lim["limits"].items():
        low = lim["readings"][name]["port_highest"]
        high = lim["readings"][name]["control_lowest"]
        assert low < limit, (name, low, limit)
        if high >= 3 * low:
            assert limit < high, (name, limit, high)
            failed.append(name)
    assert failed


def test_the_scope_check_holds_one_pool_entrys_reference_at_a_time(monkeypatch):
    """The check's float64 reference residuals are made entry by entry of the pool, and
    the last entry's are freed before the next entry's are made: they set the check's
    peak on the card."""
    made, real = [], reference.estimate

    def estimate(ref, X):
        assert all(w() is None for w in made), "an earlier entry's reference is still held"
        out = real(ref, X)
        made.append(weakref.ref(out))
        return out

    monkeypatch.setattr(reference, "estimate", estimate)
    cell = cut_cell("cells")
    loop = harness._module(cell.root, "loops", "cells").Loop(
        harness.Run(cell, 2**31 + 9, False), harness.Device("cpu"), Port(), cell)
    loop.setup()
    loop.window(cells=3, samples=(0, 1, 2))
    out = loop.check()
    assert len(made) == 3 and out["checked"] == 3  # pool entries 0, 1 and 0 again
    assert out["resid_gap"] <= cell.limits["limits"]["resid_gap"]


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, Altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("loop", sorted(CUT))
def test_each_fault_makes_the_run_not_correct(loop, fault):
    ok, shown = verdict(loop, fault())
    assert not ok, shown


def test_reference_agrees_with_the_port_at_the_cells_regularization():
    """The port (float32) and the reference (float64) on the same telemetry: the same
    memory vectors, and residuals within a few thousandths of the reference's sigma
    where reg lies above float32's resolution of G's eigenvalues."""
    from repro_torch.mset import mset2
    port_sprt_mod = importlib.import_module("repro_torch.mset.sprt")

    cfg = cut_cell("stream").config
    X = telemetry.series(5, 4096 + 256, 64, cfg["telemetry"], "cpu")
    Xtr, x = X[:4096], X[4096:]
    ref = reference.train(Xtr, 512, "inverse_distance", cfg["reg"])
    r64 = reference.estimate(ref, x)
    model = mset2.train(Xtr, 512, reg=cfg["reg"])
    r32 = mset2.estimate(model, x)[1]
    assert torch.equal(model.D.double(), ref.D)
    sigma = r64.std(dim=0)
    assert float(((r32.double() - r64).abs() / sigma).max()) < 0.01
    # the SPRT on the same residuals: the port's float32 recursion against the reference's
    params = port_sprt_mod.SPRTParams()
    s32, m32 = r32.std(dim=0, correction=0), r32.mean(dim=0)
    alarms, pos, neg = port_sprt_mod.sprt(r32, s32, params, mu=m32)
    up, lo = reference.sprt_bounds(params.alpha, params.beta)
    a_ref, l_ref = reference.sprt(r32.double(), s32.double(), m32.double(), params.m_shift, up, lo)
    assert torch.equal(alarms, a_ref)
    assert float((torch.stack([pos, neg], 1).double() - l_ref).abs().max()) < 1e-4
