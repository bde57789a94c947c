"""The port over several processes: real ``torchrun`` worlds of CPU ranks over gloo, each
rank running ``tests/torch_multiproc_rank.py``, against the one-process port and the
reference.

Three worlds run once, in order, each within WORLD_TIMEOUT: four ranks, two, then one.
The weights and AdamW state come from a step-0 checkpoint that the reference's
``Checkpointer`` writes of its ``init_values``, so every run of a job, in either
package and at any world size, starts from the same state. What they hold:

* (a) ``sharded_batch``: each rank's local rows are the rows it owns of the
  reference's ``TokenPipeline.batch``, bit for bit, at meshes (2, 2), (4, 1), (2, 1).
* (b) ``Checkpointer.restore`` with shardings: each rank's block of every leaf of the
  reference's checkpoint is ``distribute_tensor``'s, bit for bit (olmoe's 6 experts
  split unevenly over ``model`` 4, minitron on (2, 2)); the reference's ``restore``
  reads the port's world-4 checkpoint and equals its gathered state, bit for bit.
* (c) ``train`` at worlds 4 and 2 (minitron-4b; olmoe-1b-7b on the expert-parallel
  path at a capacity that drops no token): each step's loss and gradient norm within
  1e-5 of the one-process port's, whose losses are held to the reference's ``train``;
  the final parameters within 1e-5 of each leaf's largest value.
* (d) The elastic chain 4 -> 2 -> 1 of olmoe with 6 experts (padded to 8 at ``model``
  4): each link resumes a copy of the last one's checkpoint; every loss within 1e-5 of
  the uninterrupted one-process run.
* (e) A NaN at step 3 in a world of two: every rank restores step 2's checkpoint once.
* (f) ``generate`` at worlds 4 and 2: minitron-4b, olmoe-1b-7b (expert-parallel),
  mamba2-130m and seamless-m4t-large-v2 give the one-process tokens on every rank.
* (g) A world of one under ``torchrun`` equals the in-process calls.
"""

import json
import os
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import numpy as np

import repro.launch.train as jax_train_mod
import repro_torch.launch.serve as serve_mod
import repro_torch.launch.train as train_mod
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro_torch.models.model import Model
import repro.models.model as jax_model_mod
from torch_multiproc_rank import config, configs, moe_aux_weight, torchrun

ROOT = Path(__file__).resolve().parents[1]
RANK_SCRIPT = ROOT / "tests" / "torch_multiproc_rank.py"
WORLD_TIMEOUT = 120  # seconds for one world, all of its tasks
TOL = 1e-5

CASES = {
    "dense": ("minitron-4b", {}),
    "moe-ep": ("olmoe-1b-7b", {"moe_impl": "ep"}),
    "moe-ep-6": ("olmoe-1b-7b", {"moe_impl": "ep", "n_experts": 6}),
}
AUX = {"dense": None, "moe-ep": 0.0, "moe-ep-6": 0.0}  # the MoE's aux weight (see moe_aux_weight)
JOB = dict(seq_len=32, global_batch=4, ckpt_every=2, peak_lr=1e-2, warmup=2, log_every=100)
STEPS = {"dense": 4, "moe-ep": 4, "moe-ep-6": 6}
SERVE_OVER = {"moe_impl": "ep"}
SERVE_ARCHS = ["minitron-4b", "olmoe-1b-7b", "mamba2-130m", "seamless-m4t-large-v2"]
GEN = dict(batch=4, prompt_len=16, gen_tokens=6)
BATCH = dict(vocab=512, seq_len=16, global_batch=8, seed=3, steps=[0, 5])
NAN_STEP = 3


def jax_config(case):
    arch, over = CASES[case]
    cfg = jax_get_config(arch, smoke=True).replace(dtype="float32", **over)
    if cfg.moe:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.n_experts_per_tok)
    return cfg


def step0_dir(base, case):
    """A job directory holding the reference's step-0 checkpoint of ``case``: its
    ``init_values`` and a fresh AdamW state."""
    root = base / f"init-{case}"
    if not root.exists():
        cfg = jax_config(case)
        params = jax.tree.map(np.asarray, jax_build_model(cfg).init_values(jax.random.PRNGKey(0)))
        JCheckpointer(str(root / cfg.name)).save(0, (params, jadamw.init(params)))
    return root


def job_dir(base, case, name, step=0, source=None):
    """A fresh job directory holding a copy of one step of ``source`` (a job
    directory; the step-0 checkpoint by default)."""
    source = source or step0_dir(base, case)
    cfg_name = config(*CASES[case]).name
    dst = base / name
    shutil.copytree(source / cfg_name / f"step_{step:010d}", dst / cfg_name / f"step_{step:010d}")
    return dst


def job(base, case, name, step=0, source=None, **over):
    arch = CASES[case][0]
    ckpt = job_dir(base, case, name, step, source)
    return dict(JOB, arch=arch, steps=STEPS[case], ckpt_dir=str(ckpt)) | over


def train_task(base, case, name, nan_steps=(), **kw):
    task = {"kind": "train", "name": name, "over": CASES[case][1], "aux": AUX[case]}
    task["nan_steps"] = list(nan_steps)
    return dict(task, job=job(base, case, name, **kw))


def launch(base, n, tasks):
    """Run ``tasks`` in a torchrun world of ``n`` CPU ranks; {rank: {name: result}}."""
    out = base / f"world{n}"
    out.mkdir()
    spec = out / "spec.json"
    spec.write_text(json.dumps({"out": str(out), "tasks": tasks}))
    p = torchrun(n, [RANK_SCRIPT, spec], WORLD_TIMEOUT)
    assert p.returncode == 0, f"world of {n} failed:\n{p.stdout[-3000:]}\n{p.stderr[-6000:]}"
    return {r: json.loads((out / f"rank{r}.json").read_text()) for r in range(n)}


def in_process_train(case, **job_kw):
    """The one-process port's run of a job (patching the launcher's configs)."""
    saved = train_mod.get_config
    train_mod.get_config = configs(CASES[case][1])
    try:
        j = train_mod.TrainJob(device="cpu", **job_kw)
        with moe_aux_weight(AUX[case]):
            train_mod.train(j, verbose=False)
    finally:
        train_mod.get_config = saved
    return [(h["step"], h["loss"], h["grad_norm"]) for h in j.history]


def reference_train(case, **job_kw):
    """The reference's ``train`` of the same job on the same step-0 state: its losses."""
    saved = jax_train_mod.get_config
    jcfg = jax_config(case)
    jax_train_mod.get_config = lambda arch, smoke=True: jcfg
    try:
        j = jax_train_mod.TrainJob(**job_kw)
        with moe_aux_weight(AUX[case], jax_model_mod.Model):
            jax_train_mod.train(j, verbose=False)
    finally:
        jax_train_mod.get_config = saved
    return [(h["step"], h["loss"]) for h in j.history]


def in_process_serve():
    saved = serve_mod.get_config
    serve_mod.get_config = configs(SERVE_OVER)
    try:
        return {a: serve_mod.generate(a, device="cpu", **GEN).tokens.tolist() for a in SERVE_ARCHS}
    finally:
        serve_mod.get_config = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("multiproc")
    one = {
        case: in_process_train(case, **job(base, case, f"one-{case}"))
        for case in ("dense", "moe-ep", "moe-ep-6")
    }
    ref = {
        case: reference_train(case, **job(base, case, f"ref-{case}"))
        for case in ("dense", "moe-ep")
    }
    served = in_process_serve()
    serve = {"kind": "serve", "name": "serve", "over": SERVE_OVER, "archs": SERVE_ARCHS, "gen": GEN}

    def batch(name, dims):
        return dict(BATCH, kind="batch", name=name, dims=dims)

    def restore(name, case, **kw):
        ckpt = job_dir(base, case, name) / config(*CASES[case]).name
        task = {"kind": "restore", "name": name, "step": 0, "arch": CASES[case][0]}
        return dict(task, over=CASES[case][1], ckpt_dir=str(ckpt), **kw)

    w4 = launch(
        base,
        4,
        [
            batch("batch-2x2", [2, 2]),
            batch("batch-4x1", [4, 1]),
            restore("restore-dense", "dense", dims=[2, 2]),
            restore("restore-moe-6", "moe-ep-6"),
            train_task(base, "dense", "train-dense-4"),
            train_task(base, "moe-ep", "train-moe-ep-4"),
            train_task(base, "moe-ep-6", "chain-4"),
            {
                "kind": "resave",
                "name": "resave-4",
                "arch": "minitron-4b",
                "over": {},
                "step": STEPS["dense"],
                "ckpt_dir": str(base / "train-dense-4" / "minitron-4b-smoke"),
                "save_dir": str(base / "resave-4"),
            },
            serve,
        ],
    )
    w2 = launch(
        base,
        2,
        [
            batch("batch-2x1", [2, 1]),
            train_task(base, "dense", "train-dense-2"),
            train_task(base, "moe-ep", "train-moe-ep-2"),
            train_task(base, "moe-ep-6", "chain-2", step=2, source=base / "chain-4"),
            train_task(base, "dense", "nan-2", nan_steps=[NAN_STEP], steps=5),
            serve,
        ],
    )
    w2_nan = {r: w2[r]["nan-2"] for r in w2}
    w1 = launch(
        base,
        1,
        [
            train_task(base, "moe-ep-6", "chain-1", step=4, source=base / "chain-2"),
            train_task(base, "dense", "train-dense-1"),
            serve,
        ],
    )
    return dict(base=base, one=one, ref=ref, served=served, nan=w2_nan) | {4: w4, 2: w2, 1: w1}


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bar = TOL * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e}"


# ------------------------------ (a) the sharded batch ------------------------------


BATCH_MESHES = [(4, "batch-2x2", (2, 2)), (4, "batch-4x1", (4, 1)), (2, "batch-2x1", (2, 1))]


@pytest.mark.parametrize("world,name,dims", BATCH_MESHES)
def test_sharded_batch_rows_are_the_references(runs, world, name, dims):
    B = BATCH["global_batch"]
    jpipe = JTokenPipeline(BATCH["vocab"], BATCH["seq_len"], B, seed=BATCH["seed"])
    rows = B // dims[0]
    seen = set()
    for rank in range(world):
        coords = runs[world][rank][name]
        assert coords["data"] * dims[1] + coords["model"] == rank  # row-major mesh
        local = np.load(runs["base"] / f"world{world}" / f"{name}.rank{rank}.npz")
        for step in BATCH["steps"]:
            want = jpipe.batch(step)
            for k in ("tokens", "targets"):
                w = np.asarray(want[k])[coords["data"] * rows : (coords["data"] + 1) * rows]
                got = local[f"{k}_{step}"]
                assert got.shape == w.shape and np.array_equal(got, w), (rank, step, k)
        seen.add(coords["data"])
    assert seen == set(range(dims[0]))


# ------------------------------ (b) restore with shardings ------------------------------


@pytest.mark.parametrize("name", ["restore-dense", "restore-moe-6"])
def test_restore_with_shardings_is_each_ranks_block(runs, name):
    for rank, res in runs[4].items():
        r = res[name]
        assert r["step"] == 0 and len(r["equal"]) == r["n"]
        assert all(r["equal"]), [i for i, e in enumerate(r["equal"]) if not e]
        assert r["split"] > 0  # some leaves are split, not all replicated


def test_reference_restores_the_ports_world_checkpoint(runs):
    base = runs["base"]
    cfg = jax_config("dense")
    like = jax.tree.map(np.asarray, jax_build_model(cfg).init_values(jax.random.PRNGKey(1)))
    ckpt = JCheckpointer(str(base / "resave-4"))
    (params, opt), step, _ = ckpt.restore((like, jadamw.init(like)))
    assert step == STEPS["dense"] and int(opt.step) == STEPS["dense"]
    g = np.load(base / "world4" / "resave-4.npz")
    model = Model(config(*CASES["dense"]), "meta")
    for kind, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
        values = {n: torch.from_numpy(g[f"{kind}/{n}"]) for n, _ in model.named_parameters()}
        want = Model(config(*CASES["dense"]), "cpu").to_numpy(values)
        for (path, got), w in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(want)):
            got = np.asarray(got)
            assert got.dtype == w.dtype and np.array_equal(got, w), jax.tree_util.keystr(path)


# ------------------------------ (c) the trainer ------------------------------


@pytest.mark.parametrize("case", ["dense", "moe-ep"])
def test_one_process_port_trains_as_the_reference(runs, case):
    got, want = runs["one"][case], runs["ref"][case]
    assert [s for s, *_ in got] == [s for s, _ in want] == list(range(STEPS[case]))
    np.testing.assert_allclose([loss for _, loss, _ in got], [loss for _, loss in want], rtol=TOL)


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("case", ["dense", "moe-ep"])
def test_world_trains_as_one_process(runs, world, case):
    want = runs["one"][case]
    name = f"train-{case}-{world}"
    for rank, res in runs[world].items():
        got = res[name]["history"]
        assert [s for s, *_ in got] == [s for s, *_ in want], rank
        np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], rtol=TOL)
        np.testing.assert_allclose([h[2] for h in got], [h[2] for h in want], rtol=TOL)
        assert res[name]["metrics"] == runs[world][0][name]["metrics"]  # rank 0's, on all
    arch = CASES[case][0]
    cfg_name = config(*CASES[case]).name
    final = f"step_{STEPS[case]:010d}"
    one = JCheckpointer(str(runs["base"] / f"one-{case}" / cfg_name))
    got_ck = JCheckpointer(str(runs["base"] / name / cfg_name))
    like = jax_build_model(jax_config(case)).init_values(jax.random.PRNGKey(0))
    like = jax.tree.map(np.asarray, like)
    want_tree, _, _ = one.restore((like, jadamw.init(like)), STEPS[case])
    got_tree, _, _ = got_ck.restore((like, jadamw.init(like)), STEPS[case])
    assert os.path.isdir(runs["base"] / name / cfg_name / final), arch
    # in norm, leaf by leaf: AdamW's m / (sqrt(v) + eps) moves an element whose gradient
    # is near zero by a good part of lr for a rounding of that gradient (ROADMAP R13)
    for (path, w), g in zip(
        jax.tree_util.tree_leaves_with_path(want_tree[0]), jax.tree.leaves(got_tree[0])
    ):
        err = np.linalg.norm(np.asarray(g, np.float64) - w) / np.linalg.norm(w)
        assert err <= TOL, f"{jax.tree_util.keystr(path)}: {err:.3e}"


# ------------------------------ (d) the elastic chain ------------------------------


@pytest.mark.parametrize("world,first", [(4, 0), (2, 2), (1, 4)])
def test_elastic_chain_resumes_as_one_uninterrupted_run(runs, world, first):
    want = {s: (loss, gn) for s, loss, gn in runs["one"]["moe-ep-6"]}
    for rank, res in runs[world].items():
        got = res[f"chain-{world}"]["history"]
        assert [s for s, *_ in got] == list(range(first, STEPS["moe-ep-6"])), rank
        for s, loss, gn in got:
            np.testing.assert_allclose(loss, want[s][0], rtol=TOL)
            np.testing.assert_allclose(gn, want[s][1], rtol=TOL)


# ------------------------------ (e) the NaN restart ------------------------------


def test_nan_restart_ends_on_every_rank(runs):
    for rank, res in runs["nan"].items():
        assert res["metrics"]["restarts"] == 1, rank
        steps = [s for s, *_ in res["history"]]
        # restored from step 2's checkpoint: step 2 runs again, step 3 is skipped
        assert steps.count(2) == 2 and NAN_STEP not in steps[2:], steps
        assert steps[-1] == 4 and res["history"] == runs["nan"][0]["history"]


# ------------------------------ (f, g) the server; a world of one ------------------------------


@pytest.mark.parametrize("world", [4, 2, 1])
def test_world_serves_the_one_process_tokens(runs, world):
    for rank, res in runs[world].items():
        for arch in SERVE_ARCHS:
            assert res["serve"][arch] == runs["served"][arch], (rank, arch)


def test_world_of_one_trains_as_the_in_process_call(runs):
    got = runs[1][0]["train-dense-1"]["history"]
    assert got == [list(h) for h in runs["one"]["dense"]]


# ------------------------------ in this process ------------------------------


def test_a_world_refuses_a_mesh_of_another_device_type():
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    assert mesh_mod.world_size() == 1 and mesh_mod.is_main()
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        mesh_mod.init_world("tpu")
    mesh_mod.init_world("cpu")  # a lone process: a gloo world of one
    try:
        with pytest.raises(ValueError, match="started for 'cpu'"):
            mesh_mod.make_dev_mesh(device_type="cuda")
        dev = mesh_mod.make_dev_mesh(device_type="cpu")
        assert tuple(dev.shape) == (1, 1) and mesh_mod.world_size() == 1 and mesh_mod.is_main()
    finally:
        dist.destroy_process_group()


def test_sharded_batch_without_a_sharding_is_the_batch():
    from repro_torch.data import TokenPipeline

    kw = {k: BATCH[k] for k in ("seq_len", "global_batch", "seed")}
    pipe = TokenPipeline(BATCH["vocab"], device="cpu", **kw)
    got, want = pipe.sharded_batch(5, None), pipe.batch(5)
    assert all(torch.equal(got[k], want[k]) for k in ("tokens", "targets"))


def test_several_ranks_without_a_mesh_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")  # as torchrun sets it, before the world starts
    job = train_mod.TrainJob("mamba2-130m", use_mesh=False, ckpt_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="use_mesh"):
        train_mod.train(job, verbose=False)


def test_to_main_gives_rank_0_the_whole_value_alone():
    """``sharding.to_main`` (what a checkpoint's save gathers with) on a threaded world
    of 2 x 2 CPU ranks: blocks split unevenly (7 rows over 2 and over 4, 5 columns over
    2), replicated ones, and a pending sum, each whole on rank 0 and None elsewhere."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import local_part, to_main
    from torch_sharded_cases import run_world

    layouts = (
        [Shard(0), Shard(1)],
        [Shard(0), Shard(0)],
        [Replicate(), Shard(2)],
        [Shard(1), Replicate()],
    )

    def work(mesh):
        rank = dist.get_rank()
        x = torch.randn(7, 5, 3, generator=torch.Generator().manual_seed(0))
        got = [to_main(local_part(x, (mesh, list(pl)))) for pl in layouts]
        pending = DTensor.from_local(torch.full((3,), float(rank)), mesh, [Partial()] * 2)
        got.append(to_main(pending))
        want = [x] * len(layouts) + [torch.full((3,), 6.0)]
        ok = [g is None if rank else torch.equal(g, w) for g, w in zip(got, want)]
        assert all(ok), (rank, ok)
        return ok

    assert all(run_world((2, 2), work))
