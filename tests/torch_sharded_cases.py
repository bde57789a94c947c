"""Shared helpers of the port's threaded-world sharding tests
(``tests/test_torch_sharded.py``, ``tests/test_torch_sharded_families.py``).

Each rank is a thread with its own process group (``torch.testing._internal.distributed.
multi_threaded_pg``, as DTensor's own tests run), building the same model from one
parameter tree, sharded by ``Model.shard(make_rules(mesh))``; ``world(name)`` runs one
world's cases once and returns (unsharded, sharded) results by case: prefill logits,
one decode step's logits, the loss and every gradient of one training pass. Each world
is joined within WORLD_TIMEOUT.

The MoE's expert-parallel path routes each member's slice of the sequence with its own
capacity, and its aux loss is the mean of the slices' (the reference's ``pmean``), so
its cases run at a capacity that drops no token and hold the loss without the aux term.
"""

import threading
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.multi_threaded_pg import (
    ProcessLocalGroup,
    _install_threaded_pg,
    _uninstall_threaded_pg,
)

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.steps import batch_sharding, place_tree
from repro_torch.models.model import Model, build_model

TOL = 1e-5
WORLD_TIMEOUT = 300  # seconds for one world, all of its cases
B, S, SRC = 4, 32, 16

CASES = {
    "dense": ("minitron-4b", {}),
    "moe-ep": ("olmoe-1b-7b", {"moe_impl": "ep"}),
    "moe-ep-padded": ("olmoe-1b-7b", {"moe_impl": "ep", "n_experts": 6}),
    "ssm": ("mamba2-130m", {}),
    "ssm-heads-whole": ("mamba2-130m", {"ssm_headdim": 32}),  # 4 SSM heads
    "encdec": ("seamless-m4t-large-v2", {}),
}
WORLDS = {
    "2x4": ((2, 4), ["dense", "moe-ep", "moe-ep-padded"]),
    "1x8": ((1, 8), ["dense"]),
    "2x4-families": ((2, 4), ["ssm", "encdec"]),
    "1x8-families": ((1, 8), ["ssm-heads-whole"]),
}


def config(case):
    arch, over = CASES[case]
    cfg = get_config(arch, smoke=True).replace(dtype="float32", **over)
    if cfg.moe:  # every token kept, in one slice as in the whole batch
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.n_experts_per_tok)
    return cfg


def inputs(cfg):
    g = torch.Generator().manual_seed(0)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
        "targets": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
    }
    if cfg.encdec:
        batch["frames"] = torch.randn(B, SRC, cfg.d_model, generator=g)
    return batch


def steps(model, batch, aux_weight):
    """(prefill logits, one decode step's logits, loss, {name: grad}) of ``model`` (a
    serving model for the first two, its trainable twin given by the caller)."""
    serving, trainable = model
    source = {"frames": batch["frames"]} if "frames" in batch else {}
    placed = place_tree(batch, batch_sharding(trainable.rules, batch))
    cache, logits = serving.prefill(placed["tokens"], serving.init_cache(B, S + 4), **source)
    _, step_logits = serving.decode_step(cache, placed["tokens"][:, :1], S)
    loss, _ = trainable.loss(placed, moe_aux_weight=aux_weight)
    loss.backward()
    grads = {n: p.grad for n, p in trainable.named_parameters()}
    return logits, step_logits, loss.detach(), grads


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def run_world(dims, work):
    """``work(mesh)`` on every rank of a threaded world of dims' ranks, each joined
    within WORLD_TIMEOUT; rank 0's result."""
    n = int(np.prod(dims))
    ProcessLocalGroup.reset()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    store = dist.HashStore()
    results, errors = {}, {}

    def worker(rank):
        try:
            dist.init_process_group("threaded", rank=rank, world_size=n, store=store)
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
            results[rank] = work(mesh)
        except BaseException as e:  # wake the ranks waiting in a collective
            errors[rank] = traceback.format_exc()
            ProcessLocalGroup.exception_handle(e)
        # no destroy_process_group: each rank's group lives in its thread's world, which
        # _uninstall_threaded_pg drops (and torch 2.11's thread world cannot destroy)

    threads = [threading.Thread(target=worker, args=(r,), daemon=True) for r in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WORLD_TIMEOUT)
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    assert not any(t.is_alive() for t in threads), f"the world {dims} did not end in time"
    assert not errors, errors[min(errors)]
    return results[0]


_RESULTS: dict = {}


def world(name):
    """Every case of one world, run once: (unsharded, sharded) results by case."""
    if name not in _RESULTS:
        _RESULTS[name] = _run_cases(name)
    return _RESULTS[name]


def _run_cases(name):
    dims, cases = WORLDS[name]
    tp = dims[1]
    setup = {}
    for case in cases:
        cfg = config(case)
        tree = build_model(cfg, "cpu", ep_size=tp).to_numpy()
        aux = 0.0 if cfg.moe else 1e-2
        batch = inputs(cfg)

        def pair(rules=None, cfg=cfg, tree=tree):
            serving = Model.from_numpy(cfg, tree, "cpu", ep_size=tp).shard(rules)
            trainable = Model.from_numpy(cfg, tree, "cpu", trainable=True, ep_size=tp)
            return serving, trainable.shard(rules)

        setup[case] = (pair, batch, aux, steps(pair(), batch, aux))

    def work(mesh):
        rules = make_rules(mesh)
        out = {}
        for case, (pair, batch, aux, _) in setup.items():
            logits, step_logits, loss, grads = steps(pair(rules), batch, aux)
            out[case] = (
                full(logits),
                full(step_logits),
                full(loss),
                {n: full(g) for n, g in grads.items()},
            )
        return out

    sharded = run_world(dims, work)
    return {case: (setup[case][3], sharded[case]) for case in cases}


def pairs(*names):
    return [(w, c) for w in names for c in WORLDS[w][1]]


def close(got, want):
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    assert err <= TOL * scale, f"max abs error {err:.3e} against {TOL * scale:.3e}"
