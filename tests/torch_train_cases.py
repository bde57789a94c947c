"""Reference runs and checks shared by the training parity tests
(``test_torch_train.py``: every architecture's loss and gradients;
``test_torch_train_steps.py``: the training attention, the bf16 loss, remat and
``StepBuilder``'s steps).

Weights move across as the reference's ``init_values`` tree (``Model.from_numpy``);
gradients come back as the same tree (``Model.to_numpy`` of each parameter's grad).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import numpy as np

from repro.distributed import make_rules
from repro.models import build_model as jax_build_model
from repro_torch.models import Model

RULES = make_rules(None)
# float32 on both sides; the packages sum in other orders (matmuls, the embedding's
# scatter-add, the layer loop against a scan)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def port_batch(batch):
    """A batch of numpy (or jax) arrays as the port's tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def reference_grads(cfg, params, batch):
    """The reference's (loss, metrics, gradient tree), jitted."""
    jm = jax_build_model(cfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b, RULES), has_aux=True))
    (loss, metrics), grads = fn(params, batch)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_grads(cfg, params, batch, **model_kw):
    """The port's (loss, metrics, gradient tree) on the CPU, on the reference's weights."""
    model = Model.from_numpy(cfg, params, "cpu", trainable=True)
    loss, metrics = model.loss(port_batch(batch), **model_kw)
    loss.backward()
    grads = model.to_numpy({n: p.grad for n, p in model.named_parameters()})
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def check_grads(got, want, tol=GRAD_TOL):
    """Each leaf within tol * its largest |gradient|."""
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        bar = tol * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= bar, f"{jax.tree_util.keystr(path)}: {err:.3e} > {bar:.3e}"
