"""The port's examples (``examples/torch_*.py``) on the CPU, and its entry points under
``torchrun``.

Each example is loaded with importlib and its ``main`` called with ``device="cpu"``.
Where the reference's example runs on this box (``simulate_fleet.py``), the port's
printed tables equal the reference's on the numpy fleet path, and the compiled path's
(``backend="auto"``, the bin loop in torch on the CPU) equal them too. The reference's
tuner examples reach an ``"auto"`` entry point that its jax cannot run here (ROADMAP
R1), so the port's tuner examples on the compiled path are held to the same examples on
the port's ``backend="numpy"``. The port's catalog lists H100 nodes too; these runs pass
the reference's v5e shapes. The quickstart must detect its injected drift, and the
serving example must give ``generate``'s tokens.

``examples/torch_train_lm.py`` and ``examples/torch_serve_lm.py`` also run unchanged
under ``python -m torch.distributed.run --nproc-per-node 2`` with ``--device cpu``, each
world within WORLD_TIMEOUT.
"""

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro_torch.core as t_core
from torch_fleet_cases import v5e
from torch_multiproc_rank import torchrun

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 120  # seconds for one torchrun world
V5E = v5e(t_core)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example(name):
    return _load(name, f"examples/{name}.py")


def printed(fn, *args, **kw):
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def world(n, argv, tmp_path):
    p = torchrun(n, argv, WORLD_TIMEOUT, cwd=tmp_path)
    assert p.returncode == 0, f"{argv[0]}: {p.stdout[-3000:]}\n{p.stderr[-6000:]}"
    return p.stdout


# ---------------------------------- the MSET path ----------------------------------


def test_quickstart_detects_its_drift():
    fig, out = printed(example("torch_quickstart").main, "cpu")
    assert json.loads(json.dumps(fig)) == fig  # what chip_smoke.py prints
    assert "FAULT DETECTED on sensor 7" in out, out
    assert fig["detection_delay"] is not None and 0 < fig["detection_delay"] < 600
    assert fig["pre_fault_alarm_rate"] < 0.01 and 0 < fig["residual_ratio"] < 0.1


# ---------------------------------- serving and training ----------------------------------


def test_serve_example_gives_generates_tokens():
    from repro_torch.launch.serve import generate

    archs = ("minitron-4b", "mamba2-130m")
    fig, out = printed(example("torch_serve_lm").main, "cpu", archs)
    json.dumps(fig)  # what chip_smoke.py prints
    for arch in archs:
        r = generate(arch, batch=4, prompt_len=32, gen_tokens=16, device="cpu")
        assert fig[arch][1] == r.tokens[0].tolist()
        assert f"sample={r.tokens[0][:8].tolist()}" in out


def test_serve_example_under_torchrun_gives_the_one_process_tokens(tmp_path):
    from repro_torch.launch.serve import generate

    out = world(2, [ROOT / "examples/torch_serve_lm.py", "--device", "cpu"], tmp_path)
    samples = dict(re.findall(r"^(\S+)\s.*sample=(\[.*\])$", out, re.M))
    assert set(samples) == {"minitron-4b", "olmoe-1b-7b", "mamba2-130m"}, out  # rank 0 only
    assert out.count("sample=") == 3
    # olmoe's smoke config serves in bf16, where the sharded experts' partial sums round
    # otherwise and a near-tie may flip (ROADMAP R8); test_torch_multiproc.py holds the
    # sharded MoE's tokens in float32
    for arch in ("minitron-4b", "mamba2-130m"):
        r = generate(arch, batch=4, prompt_len=32, gen_tokens=16, device="cpu")
        assert json.loads(samples[arch]) == r.tokens[0][:8].tolist(), arch


def test_train_example_under_torchrun_resumes_its_world_checkpoint(tmp_path):
    argv = [ROOT / "examples/torch_train_lm.py", "--smoke", "--seq-len", "32", "--batch", "4"]
    argv += ["--device", "cpu", "--ckpt-dir", tmp_path / "ckpt"]
    first = world(2, argv + ["--steps", "4"], tmp_path)
    assert "'steps': 4" in first and "'restarts': 0" in first, first
    again = world(2, argv + ["--steps", "6"], tmp_path)  # resumes at step 4
    assert "resumed from step 4" in again and "'steps': 6" in again, again
    assert first.count("final:") == again.count("final:") == 1  # rank 0 prints


# ---------------------------------- the fleet ----------------------------------


SIM_SIZE = dict(duration_s=900.0, n_seeds=2)


@pytest.mark.parametrize("scenario", ["mset", "lm"])
def test_simulate_fleet_tables_equal_the_reference(scenario):
    pytest.importorskip("jax")  # the reference
    port = example("torch_simulate_fleet")
    ref = _load("ref_simulate_fleet", "examples/simulate_fleet.py")
    import repro.core as j_core
    import repro.fleet as j_fleet
    import repro_torch.fleet as t_fleet

    def build(fm, core):
        if scenario == "mset":
            return fm.mset_scenario(
                n_signals=1024, n_memvec=4096, fleet=8, slo_s=1.0, shapes=v5e(core)
            )
        return fm.lm_decode_scenario("minitron-4b", ctx=512, slo_s=0.25, shapes=v5e(core))

    def rate(scn):
        return 5.6 * scn.service_for(scn.rows_at()[0].shape_name).max_throughput

    want_scn = build(j_fleet, j_core)
    _, want = printed(ref.run_scenario, want_scn, rate(want_scn), **SIM_SIZE)
    scn = build(t_fleet, t_core)
    for backend in ("numpy", "auto"):
        engine = dict(backend=backend, device="cpu", **SIM_SIZE)
        _, got = printed(port.run_scenario, scn, rate(scn), **engine)
        assert got == want, backend
    if scenario == "mset":
        _, want = printed(ref.run_disciplines, want_scn, **SIM_SIZE)
        for backend in ("numpy", "auto"):
            _, got = printed(port.run_disciplines, scn, backend=backend, device="cpu", **SIM_SIZE)
            assert got == want, backend


TUNER_EXAMPLES = {
    "torch_observe_fleet": {},
    "torch_oracle_query": {},
    "torch_tune_autoscaler": dict(duration_s=1800.0, n_seeds=6, n_candidates=12),
    "torch_closed_loop": {},
}


@pytest.mark.parametrize("name", sorted(TUNER_EXAMPLES))
def test_tuner_example_on_the_compiled_path_equals_numpy(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the examples' artifacts (events, oracle table)
    main = example(name).main
    kw = dict(TUNER_EXAMPLES[name], shapes=V5E)
    got, out = printed(main, "cpu", "auto", **kw)
    want, _ = printed(main, "cpu", "numpy", **kw)
    json.dumps(got)  # what chip_smoke.py prints
    if name == "torch_observe_fleet":  # the compiled path's dispatches add event records
        assert got.pop("records") > want.pop("records") > 0
        assert not got["fresh_drifted"] and got["degraded_drifted"], out
        assert (tmp_path / "observe_fleet_events.jsonl").exists()
    assert got == want
    if name == "torch_oracle_query":
        assert "outside gridded range" in got["refused"], out
        assert (tmp_path / "oracle_table.json").exists()
    if name == "torch_closed_loop":
        assert got["swaps"] >= 1 and abs(got["est_factor"] - 2.0) < 0.25, out
