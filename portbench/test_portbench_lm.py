"""The ``lm`` system and the ``prefill`` loop, driven through whole runs on the CPU at
the smoke size of the cell's model (``granite-4.0-h-small``'s one period of 10 layers
at tiny widths), with the cell's own check and limits: the port passes, a planted fault
fails, the control runs the same loop. And the counts behind the cell's shares.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from portbench import counts_lm, harness  # noqa: E402
from portbench.loops.prefill import zipf_tokens  # noqa: E402
from portbench.systems.lm import Control, Port  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
WORKLOAD = "granite-h-prefill-8k"
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Smoke(Port):
    """The port at the smoke size of the configuration's arch."""

    def arch(self, cfg):
        from repro_torch.configs import get_config

        return get_config(cfg["arch"], smoke=True)


def cut() -> harness.Cell:
    from repro_torch.configs import get_config

    cell = harness.load_cell(WORKLOAD, BENCH)
    cell.config = dict(cell.config, **get_config(cell.config["arch"], smoke=True).published())
    cell.traffic = dict(cell.traffic, batch=2, prompt_len=48, pool=2, decode_steps=3, warmup_units=1)
    return cell


def run(sut, traced=False, seconds=0.6):
    return harness.run(cut(), SEED, seconds, traced, device="cpu", sut=sut)


def test_the_port_is_correct_and_reports_the_cells_metrics():
    r = run(Smoke())
    ok, shown = harness.verdict(r)
    assert ok and r.checks["checked"] >= 1, shown
    assert set(r.checks) >= {"prefill_rms", "decode_rms", "prefill_gap", "decode_gap", "state_rms"}
    assert r.checks["state_rms"] < 1e-5  # float32 on both sides: the same sums in another order
    res = harness.result(r, "cpu", 1)
    assert set(res["metrics"]) == {"setup_s", "obs_per_s", "p95_ms"}
    assert r.unit_obs == 2 * 48 and len(r.latencies_ms) == r.units
    traced = harness.result(run(Smoke(), traced=True), "cpu", 1)["metrics"]
    # the device readers find no kernels on the CPU and say nothing
    assert set(traced) == {"mfu.prefill", "idle_share.prefill"}


class LostCache(Smoke):
    """A fault: decode starts from an empty cache, as if the prefill's state were lost."""

    def decode(self, cache, tokens, first, n):
        for layer in cache:
            for entry in layer.values():
                for t in entry.values():
                    t.zero_()
        return super().decode(cache, tokens, first, n)


class NoSharedExpert(Smoke):
    """A fault: the shared expert's output left out of every layer."""

    def prepare(self, cfg, seed, device):
        super().prepare(cfg, seed, device)
        for block in self.model.blocks:
            block.ffn.shared_down = torch.nn.Parameter(torch.zeros_like(block.ffn.shared_down),
                                                       requires_grad=False)


class Bfloat16State(Smoke):
    """A fault: the SSD's state after the prompt stored in bfloat16, a step below the
    configuration's float32, the scan and the products untouched."""

    def prefill(self, tokens, extra, tap=None):
        from repro_torch.models import mamba

        real = mamba.ssd_chunked

        def rounded(cfg, xh, dt, A, Bm, Cm, init_state=None):
            y, s = real(cfg, xh, dt, A, Bm, Cm, init_state)
            return y, s.bfloat16().float()

        mamba.ssd_chunked = rounded
        try:
            return super().prefill(tokens, extra, tap)
        finally:
            mamba.ssd_chunked = real


@pytest.mark.parametrize("fault", [LostCache, NoSharedExpert, Bfloat16State])
def test_a_planted_fault_is_not_correct(fault):
    ok, shown = harness.verdict(run(fault()))
    assert not ok, shown


def test_the_control_runs_the_same_loop():
    """The control (the reference with its float32 parts in bfloat16) runs the loop and
    fails the check on the first Mamba-2 layer's state, which it computes in bfloat16."""
    r = run(Control(), seconds=0.2)
    assert r.checks["checked"] >= 1 and all(
        torch.isfinite(torch.tensor(v)) for v in r.checks.values())
    ok, shown = harness.verdict(r)
    assert not ok and shown["state_rms"]["value"] > shown["state_rms"]["limit"], shown


def test_a_program_without_the_arch_fails_before_drawing_weights():
    cell = cut()
    cell.config = dict(cell.config, arch="no-such-arch")
    with pytest.raises(KeyError):
        harness.run(cell, SEED, 0.1, False, device="cpu", sut=Port())


def test_prompts_are_zipf_and_the_same_under_a_seed():
    a = zipf_tokens(SEED, (4, 4096), 1000, 1.0, "cpu", 0)
    assert torch.equal(a, zipf_tokens(SEED, (4, 4096), 1000, 1.0, "cpu", 0))
    assert not torch.equal(a, zipf_tokens(SEED, (4, 4096), 1000, 1.0, "cpu", 1))
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    top = torch.bincount(a.flatten(), minlength=1000).max() / a.numel()
    harmonic = sum(1 / r for r in range(1, 1001))
    assert abs(float(top) - 1 / harmonic) < 0.02  # the commonest id: rank 1's share


def test_prefill_counts_at_the_cells_shapes():
    cell = harness.load_cell(WORKLOAD, BENCH)
    c, tr = cell.config, cell.traffic
    B, S = tr["batch"], tr["prompt_len"]
    assert counts_lm.attention_layers(c) == 1
    # 32 query heads of 128, causal over 8,192 positions
    assert counts_lm.attention_flops(c, B, S) == 4 * B * 32 * 128 * S * (S + 1) / 2
    per_token = 9 * counts_lm.matmul_flops_per_token(c, "mamba") + counts_lm.matmul_flops_per_token(c, "attention")
    assert round(per_token / 1e8) == 42  # 2.1 B active weights a token in 10 layers
    total = counts_lm.prefill_flops(c, B, S)
    assert 140e12 < total < 146e12 and total > per_token * B * S
