"""The port's fault-tolerant trainer on the CPU: tests/test_system.py's four training
tests (loss falls, NaN recovery, resume, straggler) with the same jobs and
assertions, the watchdog, and ``examples/torch_train_lm.py``."""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np

from repro_torch.distributed.fault import FaultInjector, StepWatchdog, loss_is_bad
from repro_torch.launch.train import TrainJob, main, train

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def test_training_loss_decreases(tmp_path):
    job = TrainJob(
        arch="mamba2-130m",
        steps=30,
        seq_len=128,
        global_batch=4,
        ckpt_dir=str(tmp_path),
        log_every=100,
        device=CPU,
    )
    m = train(job, verbose=False)
    assert m["final_loss"] < m["first_loss"] - 0.5, m
    assert m["restarts"] == 0


def test_training_recovers_from_nan(tmp_path):
    inj = FaultInjector(nan_steps={12})
    job = TrainJob(
        arch="mamba2-130m",
        steps=25,
        seq_len=64,
        global_batch=4,
        ckpt_dir=str(tmp_path),
        ckpt_every=5,
        injector=inj,
        log_every=100,
        device=CPU,
    )
    m = train(job, verbose=False)
    assert m["restarts"] == 1
    assert m["steps"] >= 25
    assert np.isfinite(m["final_loss"])
    # restored from step 10's checkpoint, steps 10 and 11 run again, 12 is skipped
    steps = [h["step"] for h in job.history]
    assert steps.count(10) == 2 and 12 not in steps


def test_training_resumes_from_checkpoint(tmp_path):
    kw = dict(
        arch="mamba2-130m",
        seq_len=64,
        global_batch=4,
        ckpt_dir=str(tmp_path),
        ckpt_every=5,
        log_every=100,
        device=CPU,
    )
    train(TrainJob(steps=10, **kw), verbose=False)
    job2 = TrainJob(steps=20, **kw)
    m = train(job2, verbose=False)
    first_resumed_step = job2.history[0]["step"]
    assert first_resumed_step >= 10  # did not restart from scratch
    assert m["final_loss"] < 7.0


def test_straggler_watchdog_flags_slow_steps(tmp_path):
    inj = FaultInjector(slow_steps={15}, slow_s=0.5)
    job = TrainJob(
        arch="mamba2-130m",
        steps=20,
        seq_len=64,
        global_batch=4,
        ckpt_dir=str(tmp_path),
        injector=inj,
        log_every=100,
        device=CPU,
    )
    m = train(job, verbose=False)
    assert m["straggler_events"] >= 1


def test_nan_without_a_checkpoint_starts_over(tmp_path):
    job = TrainJob(
        arch="minitron-4b",
        steps=4,
        seq_len=32,
        global_batch=2,
        ckpt_dir=str(tmp_path),
        injector=FaultInjector(nan_steps={1}),
        log_every=100,
        device=CPU,
    )
    m = train(job, verbose=False)
    assert m["restarts"] == 1 and [h["step"] for h in job.history] == [0, 0, 2, 3]
    assert job.history[0]["loss"] == job.history[1]["loss"]  # the same weights, redrawn


def test_watchdog_unit():
    wd = StepWatchdog(threshold=3.0, warmup_steps=2)
    for i in range(10):
        assert not wd.observe(i, 0.1)
    assert wd.observe(10, 1.0)  # 10x the EWMA
    assert not wd.observe(11, 0.1)  # baseline not poisoned
    assert loss_is_bad(float("nan")) and loss_is_bad(float("-inf")) and not loss_is_bad(2.0)


def test_train_cli(tmp_path, capsys):
    argv = ["--arch", "olmoe-1b-7b", "--steps", "3", "--seq-len", "16", "--batch", "2"]
    main(argv + ["--ckpt-dir", str(tmp_path), "--device", CPU])
    assert "[train] done" in capsys.readouterr().out
    assert (tmp_path / "olmoe-1b-7b-smoke" / "step_0000000003" / "manifest.json").exists()


def test_train_lm_example_runs_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py"
    )
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--smoke", "--steps", "4", "--seq-len", "32", "--batch", "4", "--device", CPU]
    r = example.main(argv + ["--ckpt-dir", str(tmp_path)])
    job, m = r["job"], r["metrics"]
    assert job["n_microbatches"] == 2 and job["peak_lr"] == 6e-4 and m["steps"] == 4
    assert np.isfinite(m["final_loss"]) and "loss curve" in capsys.readouterr().out
