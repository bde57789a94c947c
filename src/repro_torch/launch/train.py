"""Fault-tolerant training driver: the JAX package's ``launch/train.py``.

data pipeline -> (sharded) train_step -> watchdog -> checkpoints -> restart.

One process trains on its device. Under ``torchrun`` each of N > 1 processes takes one
device and the job trains on a mesh of them (``make_dev_mesh``), the reference's
multi-device run: the model sharded, the batch placed by the batch axes, checkpoints
restored with the mesh's shardings from any world size. Rank 0 alone prints and writes;
every rank returns rank 0's metrics.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch mamba2-130m --device cpu      # 4 CPU ranks
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --full \\
        --seq-len 2048 --batch 8 --microbatches 2          # on the card
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed.fault import FaultInjector, StepWatchdog, loss_is_bad
from repro_torch.distributed.sharding import full, make_rules
from repro_torch.launch.mesh import from_main, is_main, make_dev_mesh, world_size
from repro_torch.launch.steps import StepBuilder, batch_sharding
from repro_torch.optim import AdamWConfig, warmup_cosine


@dataclass
class TrainJob:
    """The reference's job, field for field, plus ``device`` (None -> cuda).
    ``use_mesh``: in a world of several ranks, train on a mesh of them; a world of
    several ranks without it raises, for its ranks would each train alone."""

    arch: str
    smoke: bool = True
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    n_microbatches: int = 1
    peak_lr: float = 3e-3
    warmup: int = 20
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 25
    keep: int = 3
    seed: int = 0
    use_mesh: bool = True
    log_every: int = 10
    max_restarts: int = 3
    injector: Optional[FaultInjector] = None
    history: list = field(default_factory=list)
    device: Any = None


def build(job: TrainJob):
    """(cfg, mesh, StepBuilder, TokenPipeline) of the job, on its device; the mesh is
    None in a world of one."""
    cfg = get_config(job.arch, smoke=job.smoke)
    dev = resolve_device(job.device)
    mesh = None
    if world_size() > 1:
        if not job.use_mesh:
            raise ValueError(f"a world of {world_size()} ranks trains on a mesh: use_mesh")
        mesh = make_dev_mesh(device_type=dev.type)
    rules = None if mesh is None else make_rules(mesh)
    opt = AdamWConfig(lr=warmup_cosine(job.peak_lr, job.warmup, job.steps))
    sb = StepBuilder(cfg, job.n_microbatches, opt, dev, seed=job.seed, rules=rules)
    pipe = TokenPipeline(
        cfg.vocab_size, job.seq_len, job.global_batch, seed=job.seed, device=sb.model.device
    )
    return cfg, mesh, sb, pipe


def train(job: TrainJob, verbose: bool = True) -> dict:
    cfg, mesh, sb, pipe = build(job)
    verbose = verbose and is_main()
    ckpt = Checkpointer(os.path.join(job.ckpt_dir, cfg.name), keep=job.keep)
    watchdog = StepWatchdog()
    start_step = 0
    shardings = sharded = None
    if mesh is not None:
        shardings = (sb.param_shardings(), sb.opt_shardings(sb.param_shardings()))
        like = torch.empty(job.global_batch, job.seq_len, device="meta")
        sharded = batch_sharding(sb.rules, {"tokens": like})["tokens"]

    # resume if checkpoints exist (elastic: works across world sizes)
    if ckpt.latest_step() is not None:
        tree, start_step, _ = ckpt.restore_latest_valid(sb.state_like(), shardings)
        sb.load_state_tree(tree)
        if verbose:
            print(f"[train] resumed from step {start_step}")

    restarts = 0
    step = start_step
    poisoned: set[int] = set()  # data windows that produced bad losses
    t_train0 = time.time()
    while step < job.steps:
        if step in poisoned:  # skip bad data windows after a restore
            step += 1
            continue
        batch = pipe.sharded_batch(step, sharded)
        t0 = time.perf_counter()
        if job.injector:
            job.injector.maybe_stall(step)  # simulated straggler device
        metrics = sb.train_step(batch)
        loss = full(metrics["loss"])  # replicated: every rank takes the same branch
        if job.injector:
            loss = job.injector.corrupt_loss(step, loss)
        loss_v = float(loss)  # the step's one wait for the card
        gnorm_v = float(full(metrics["grad_norm"]))  # read on every rank every step
        dt = time.perf_counter() - t0

        if loss_is_bad(loss_v):
            restarts += 1
            poisoned.add(step)
            if restarts > job.max_restarts:
                raise RuntimeError(f"too many restarts ({restarts}) at step {step}")
            if verbose:
                print(
                    f"[train] BAD LOSS at step {step}; restoring last checkpoint "
                    f"(restart {restarts}/{job.max_restarts})"
                )
            ckpt.wait()  # the pending write lands, and every rank sees it
            if ckpt.latest_step() is not None:
                tree, step, _ = ckpt.restore_latest_valid(sb.state_like(), shardings)
                sb.load_state_tree(tree)
            else:
                sb.reset(job.seed)
                step = 0
            continue

        slow = watchdog.observe(step, dt) if step > start_step else False
        job.history.append(
            {"step": step, "loss": loss_v, "grad_norm": gnorm_v, "dt": dt, "slow": slow}
        )
        if verbose and (step % job.log_every == 0 or slow):
            print(
                f"[train] step {step:5d} loss {loss_v:.4f} "
                f"gnorm {gnorm_v:.2f} {dt * 1e3:.0f}ms"
                + ("  <-- straggler" if slow else "")
            )
        step += 1
        if step % job.ckpt_every == 0:
            ckpt.save_async(step, sb.state_tree(), extra={"loss": loss_v})
    ckpt.wait()
    ckpt.save(job.steps, sb.state_tree())
    metrics_out = {
        "final_loss": job.history[-1]["loss"] if job.history else float("nan"),
        "first_loss": job.history[0]["loss"] if job.history else float("nan"),
        "steps": step,
        "restarts": restarts,
        "straggler_events": len(watchdog.events),
        "wall_s": time.time() - t_train0,
    }
    metrics_out = from_main(metrics_out)
    if verbose:
        print(f"[train] done: {metrics_out}")
    return metrics_out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    job = TrainJob(
        arch=args.arch,
        smoke=not args.full,
        steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.batch,
        n_microbatches=args.microbatches,
        peak_lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    train(job)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
