"""The port's checkpointer (tests/test_checkpoint.py's cases), and checkpoints carried
between the packages: the port writes the reference's on-disk format, so a
(params, AdamW state) checkpoint that either package writes restores in the other,
bit for bit.
"""

import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro_torch import _tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch.steps import StepBuilder
from repro_torch.optim import adamw


@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4)}, "step_count": torch.tensor(7)}


def _zeros_like(tree):
    return _tree.map(torch.zeros_like, tree)


def test_roundtrip(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, tree)
    restored, step, extra = ck.restore(_zeros_like(tree))
    assert step == 5 and extra == {}
    np.testing.assert_array_equal(restored["params"]["w"], tree["params"]["w"].numpy())
    assert int(restored["step_count"]) == 7


def test_latest_and_keep_n(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4, 5]:
        ck.save(s, tree)
    assert ck.all_steps() == [4, 5]
    assert ck.latest_step() == 5


def test_async_save(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(9, tree, extra={"loss": 1.25})
    tree["params"]["w"].add_(1.0)  # the snapshot was taken before the thread started
    ck.wait()
    restored, step, extra = ck.restore(_zeros_like(tree))
    assert step == 9 and extra["loss"] == 1.25
    np.testing.assert_array_equal(restored["params"]["w"], np.arange(12.0).reshape(3, 4))


def test_corrupted_checkpoint_falls_back(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(1, tree)
    ck.save(2, tree)
    # corrupt the newest
    with open(os.path.join(str(tmp_path), "step_0000000002", "leaf_00000.npy"), "wb") as f:
        f.write(b"garbage")
    _, step, _ = ck.restore_latest_valid(_zeros_like(tree))
    assert step == 1


def test_optimizer_state_roundtrip(tmp_path):
    params = {"w": torch.ones((4, 4))}
    ck = Checkpointer(str(tmp_path))
    ck.save(3, (params, adamw.init(params)))
    (p2, st2), step, _ = ck.restore((_zeros_like(params), adamw.init(params)))
    assert step == 3
    assert isinstance(st2, adamw.AdamWState) and int(st2.step) == 0
    np.testing.assert_array_equal(p2["w"], 1.0)


def test_interrupted_write_is_invisible(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    # simulate a crash mid-write: leave a .tmp dir behind
    os.makedirs(os.path.join(str(tmp_path), "step_0000000002.tmp"))
    assert ck.latest_step() == 1
    ck.save(3, tree)
    assert ck.latest_step() == 3


def test_restore_refuses_another_tree(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"w": torch.zeros(1)})


def test_leaves_are_numbered_in_the_references_order(tmp_path):
    t = {"b": (np.ones(1), {"z": np.ones(2), "a": np.ones(3)}), "a": [np.ones(4), None]}
    Checkpointer(str(tmp_path / "port")).save(1, t)
    JCheckpointer(str(tmp_path / "ref")).save(1, t)
    for i in range(4):
        name = f"step_0000000001/leaf_{i:05d}.npy"
        assert np.load(tmp_path / "port" / name).shape == np.load(tmp_path / "ref" / name).shape


# ------------------------------ across the packages ------------------------------


ARCHS = ["minitron-4b", "mamba2-130m", "olmoe-1b-7b", "seamless-m4t-large-v2"]


def _trained(arch):
    """A smoke model's StepBuilder on the CPU after two AdamW steps (moments nonzero)."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    sb = StepBuilder(cfg, device="cpu", seed=1)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    if cfg.encdec:
        batch["frames"] = torch.randn(2, 32, cfg.d_model, generator=g)
    for _ in range(2):
        sb.train_step(batch)
    return sb


def _reference_state(arch, seed=0):
    jm = jax_build_model(jax_get_config(arch, smoke=True).replace(dtype="float32"))
    params = jm.init_values(jax.random.PRNGKey(seed))
    st = jadamw.init(params)
    return params, st._replace(
        step=jnp.asarray(5, jnp.int32),
        mu=jax.tree.map(lambda p: p * 0.5, params),
        nu=jax.tree.map(jnp.square, params),
    )


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    sb = _trained(arch)
    Checkpointer(str(tmp_path)).save(2, sb.state_tree(), extra={"loss": 1.5})
    (params, st), step, extra = JCheckpointer(str(tmp_path)).restore(_reference_state(arch))
    assert step == 2 and extra == {"loss": 1.5} and int(st.step) == 2
    for got, want in (
        (params, sb.model.to_numpy()),
        (st.mu, sb.model.to_numpy(sb.opt_state.mu)),
        (st.nu, sb.model.to_numpy(sb.opt_state.nu)),
    ):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    params, st = _reference_state(arch)
    JCheckpointer(str(tmp_path)).save(7, (params, st))
    sb = StepBuilder(get_config(arch, smoke=True).replace(dtype="float32"), device="cpu")
    tree, step, _ = Checkpointer(str(tmp_path)).restore(sb.state_like())
    sb.load_state_tree(tree)
    assert step == 7 and int(sb.opt_state.step) == 5
    for got, want in (
        (sb.model.to_numpy(), params),
        (sb.model.to_numpy(sb.opt_state.mu), st.mu),
        (sb.model.to_numpy(sb.opt_state.nu), st.nu),
    ):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
