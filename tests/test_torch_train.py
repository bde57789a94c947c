"""The port's training path against the JAX package's on the CPU: the loss, its
metrics and every gradient of each registered architecture's smoke config in float32,
on the reference's weights (``init_values``) and tests/test_models_smoke.py's batch;
and the training forward's attention, which never reaches K2.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import numpy as np

import repro_torch.models.layers as layers
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from test_models_smoke import KEY, _batch
from torch_train_cases import LOSS_RTOL, check_grads, port_batch, port_grads, reference_grads

METRICS = ("nll", "z_loss", "moe_aux")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init_values(KEY))
    batch = jax.tree.map(np.asarray, _batch(jcfg))
    loss, metrics, grads = reference_grads(jcfg, params, batch)
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    got_loss, got_metrics, got_grads = port_grads(cfg, params, batch)
    np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
    for k in METRICS:
        np.testing.assert_allclose(got_metrics[k], metrics[k], rtol=LOSS_RTOL, atol=1e-7)
    check_grads(got_grads, grads)


def test_training_never_launches_the_flash_kernel(monkeypatch):
    """Training attention is the reference's plain _sdpa: K2 has no backward, and on the
    card its output would carry no gradient to wq, wk and wv."""

    def refuse(*args, **kw):
        raise AssertionError("the training forward reached gqa_attention")

    monkeypatch.setattr(layers, "gqa_attention", refuse)
    for arch in ("minitron-4b", "seamless-m4t-large-v2", "jamba-v0.1-52b"):
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        model = build_model(cfg, "cpu", torch.Generator().manual_seed(0), trainable=True)
        batch = port_batch(jax.tree.map(np.asarray, _batch(cfg)))
        model.loss(batch)[0].backward()
        for name, p in model.named_parameters():
            if name.split(".")[-1] in ("wq", "wk", "wv"):
                assert p.grad is not None and bool(p.grad.abs().max() > 0), name


def test_trainable_model_holds_float32_parameters_and_serving_does_not():
    cfg = get_config("minitron-4b", smoke=True)  # bfloat16
    g = torch.Generator().manual_seed(0)
    train_model = build_model(cfg, "cpu", g, trainable=True)
    serve_model = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(train_model.named_parameters(), serve_model.named_parameters()):
        assert p.dtype == torch.float32 and p.requires_grad, name
        assert not q.requires_grad
        assert torch.equal(p.to(q.dtype), q), name  # the same draws, stored wider
    assert serve_model.blocks[0].mixer.wq.dtype == torch.bfloat16
