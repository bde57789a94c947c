"""One rank of a process world for ``tests/test_torch_multiproc.py``.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/torch_multiproc_rank.py SPEC.json

SPEC.json holds ``{"out": dir, "tasks": [...]}``; each task is a dict with a ``kind``
and a ``name``. The rank joins the world through the port's own ``init_world`` (gloo,
``--device cpu``), runs the tasks in order (each one's collectives in the same order on
every rank) and writes ``{name: result}`` to ``out/rank<r>.json``. Arrays go to
``out/<name>.rank<r>.npz``. It imports the port only, never the reference.

Kinds:

* ``batch``: ``TokenPipeline.sharded_batch`` on a mesh of ``dims``; this rank's local
  tokens and targets, and its ``data`` coordinate.
* ``restore``: ``Checkpointer.restore`` with the shardings of a ``StepBuilder`` on the
  world's mesh (or ``dims``); each rank's local block of each leaf against
  ``distribute_tensor``'s block of the saved array, bit for bit.
* ``resave``: a checkpoint restored sharded into a ``StepBuilder``, saved again by the
  world (``save`` of ``state_tree()``: each leaf gathered to rank 0 alone), and the state gathered parameter by parameter (``full_tensor``) to
  ``.npz`` on rank 0.
* ``train``: ``launch.train.train`` of a job; its history and metrics.
* ``serve``: ``launch.serve.generate`` for each arch; the tokens.
"""

import contextlib
import faulthandler
import functools
import json
import os
import sys

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor

import repro_torch.launch.serve as serve_mod
import repro_torch.launch.train as train_mod
from repro_torch import _tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed.fault import FaultInjector
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import init_world, make_dev_mesh
from repro_torch.launch.mesh import torchrun as run_world
from repro_torch.launch.steps import StepBuilder, batch_sharding
from repro_torch.models.model import Model


def torchrun(n, argv, timeout, cwd=None):
    """``launch.mesh.torchrun``: a world of ``n`` CPU ranks running ``argv``
    (``PYTHONPATH`` the checkout's ``src``) at niceness 10, killed whole when it
    outlasts ``timeout``. Returns the completed process; raises TimeoutError with what
    it printed."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    env["RANK_DUMP_AFTER_S"] = str(max(timeout - 10, 1))
    # niced: the ranks' steady load would otherwise stall other tests' OpenMP threads
    return run_world(n, argv, timeout, env=env, cwd=cwd, preexec_fn=lambda: os.nice(10))


def config(arch, over):
    """The smoke config of ``arch`` in float32 with ``over``; an MoE at a capacity that
    drops no token (``tests/torch_sharded_cases.py``)."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32", **over)
    if cfg.moe:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.n_experts_per_tok)
    return cfg


def configs(over):
    """A ``get_config`` for the launchers that gives ``config(arch, over)``."""
    return lambda arch, smoke=True: config(arch, over)


@contextlib.contextmanager
def moe_aux_weight(weight, model_cls=Model):
    """``model_cls.loss`` with ``moe_aux_weight=weight`` (None: as it is). On a mesh the
    expert-parallel path's aux loss is the mean of its slices' (the reference's
    ``pmean``), not the whole batch's: an MoE run held against one process takes none
    (``tests/torch_sharded_cases.py``)."""
    if weight is None:
        yield
        return
    saved = model_cls.loss
    model_cls.loss = functools.partialmethod(saved, moe_aux_weight=weight)
    try:
        yield
    finally:
        model_cls.loss = saved


def mesh_of(dims):
    if dims is None:
        return make_dev_mesh(device_type="cpu")
    return init_device_mesh("cpu", tuple(dims), mesh_dim_names=("data", "model"))


def run_batch(t, rank, out):
    mesh = mesh_of(t["dims"])
    pipe = TokenPipeline(t["vocab"], t["seq_len"], t["global_batch"], seed=t["seed"], device="cpu")
    like = {"tokens": torch.empty(t["global_batch"], t["seq_len"], device="meta")}
    sharding = batch_sharding(make_rules(mesh), like)["tokens"]
    arrays = {}
    for step in t["steps"]:
        b = pipe.sharded_batch(step, sharding)
        for k, v in b.items():
            assert isinstance(v, DTensor) and tuple(v.shape) == (t["global_batch"], t["seq_len"])
            arrays[f"{k}_{step}"] = v.to_local().numpy()
    np.savez(os.path.join(out, f"{t['name']}.rank{rank}.npz"), **arrays)
    return {"data": mesh.get_local_rank("data"), "model": mesh.get_local_rank("model")}


def run_restore(t, rank, out):
    mesh = mesh_of(t.get("dims"))
    sb = StepBuilder(config(t["arch"], t["over"]), device="cpu", rules=make_rules(mesh))
    shardings = (sb.param_shardings(), sb.opt_shardings(sb.param_shardings()))
    ckpt = Checkpointer(t["ckpt_dir"])
    tree, step, _ = ckpt.restore(sb.state_like(), t["step"], shardings)
    d = os.path.join(t["ckpt_dir"], f"step_{step:010d}")
    leaves = _tree.leaves(tree)
    equal, split = [], 0
    for i, leaf in enumerate(leaves):
        saved = torch.from_numpy(np.load(os.path.join(d, f"leaf_{i:05d}.npy")))
        if not isinstance(leaf, DTensor):
            equal.append(bool(np.array_equal(np.asarray(leaf), saved.numpy())))
            continue
        want = distribute_tensor(saved, leaf.device_mesh, leaf.placements).to_local()
        got = leaf.to_local()
        split += tuple(got.shape) != tuple(saved.shape)
        equal.append(got.dtype == want.dtype and torch.equal(got, want))
    sb.load_state_tree(tree)  # every leaf lands in the model and the AdamW state
    return {"equal": equal, "split": split, "n": len(leaves), "step": step}


def run_resave(t, rank, out):
    mesh = mesh_of(t.get("dims"))
    sb = StepBuilder(config(t["arch"], t["over"]), device="cpu", rules=make_rules(mesh))
    shardings = (sb.param_shardings(), sb.opt_shardings(sb.param_shardings()))
    tree, step, _ = Checkpointer(t["ckpt_dir"]).restore(sb.state_like(), t["step"], shardings)
    sb.load_state_tree(tree)
    Checkpointer(t["save_dir"]).save(step, sb.state_tree())
    gathered = {}
    for kind, values in (
        ("params", sb.params),
        ("mu", sb.opt_state.mu),
        ("nu", sb.opt_state.nu),
    ):
        for n, v in values.items():
            gathered[f"{kind}/{n}"] = v.detach().full_tensor().numpy()
    if rank == 0:
        np.savez(os.path.join(out, f"{t['name']}.npz"), **gathered)
    return {"step": step}


def run_train(t, rank, out):
    train_mod.get_config = configs(t["over"])
    injector = FaultInjector(nan_steps=t.get("nan_steps", ()))
    job = train_mod.TrainJob(injector=injector, device="cpu", **t["job"])
    with moe_aux_weight(t.get("aux")):
        metrics = train_mod.train(job, verbose=False)
    hist = [(h["step"], h["loss"], h["grad_norm"]) for h in job.history]
    return {"history": hist, "metrics": metrics}


def run_serve(t, rank, out):
    serve_mod.get_config = configs(t["over"])
    got = {}
    for arch in t["archs"]:
        r = serve_mod.generate(arch, device="cpu", **t["gen"])
        got[arch] = r.tokens.tolist()
    return got


KINDS = {
    "batch": run_batch,
    "restore": run_restore,
    "resave": run_resave,
    "train": run_train,
    "serve": run_serve,
}


def main(spec_path):
    # a rank that hangs shows where, before the world's timeout kills it
    faulthandler.dump_traceback_later(float(os.environ.get("RANK_DUMP_AFTER_S", 110)))
    with open(spec_path) as f:
        spec = json.load(f)
    init_world("cpu")
    rank = torch.distributed.get_rank()
    results = {}
    for t in spec["tasks"]:
        results[t["name"]] = KINDS[t["kind"]](t, rank, spec["out"])
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
