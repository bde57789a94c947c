"""The port's training attention (``_sdpa_heads`` against the reference's ``_sdpa``),
its bf16 loss, remat, and microbatched AdamW steps through ``StepBuilder``, against
the JAX package's on the CPU. Batches are tests/test_models_smoke.py's ``_batch`` or
``TokenPipeline``'s, which both packages draw alike.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import jax.numpy as jnp
import numpy as np

import repro_torch.models.layers as layers
from repro.configs import get_config as jax_get_config
from repro.data import TokenPipeline as JTokenPipeline
from repro.launch.steps import StepBuilder as JStepBuilder
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.models.layers import _sdpa as jax_sdpa
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.launch.steps import StepBuilder
from repro_torch.models import build_model, mamba, moe
from repro_torch.optim import AdamWConfig, warmup_cosine
from test_models_smoke import KEY, _batch
from torch_train_cases import (
    LOSS_RTOL,
    RULES,
    check_grads,
    port_batch,
    port_grads,
    reference_grads,
)


# ------------------------------ the training attention ------------------------------


def _qkv(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, v


def _both_sdpa(cfg_kw, q, k, v, **kw):
    jcfg = jax_get_config("minitron-4b", smoke=True).replace(**cfg_kw)
    cfg = get_config("minitron-4b", smoke=True).replace(**cfg_kw)
    want = np.asarray(jax_sdpa(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = layers._sdpa_heads(cfg, *map(torch.from_numpy, (q, k, v)), **kw).numpy()
    return got, want


@pytest.mark.parametrize(
    "shape,kw",
    [
        ((2, 128, 4, 2, 16), dict(causal=True)),
        ((2, 64, 4, 4, 16), dict(causal=False)),
        ((2, 48, 4, 1, 32), dict(causal=False, kv_valid_len=40)),
        ((2, 48, 4, 2, 16), dict(causal=True, kv_valid_len=33)),
        ((1, 96, 2, 2, 16), dict(causal=True, q_chunk=16)),
        ((2, 128, 4, 2, 16), dict(causal=False, q_chunk=32)),
        ((2, 64, 4, 2, 16), dict(causal=True, q_chunk=16, q_offset=0, kv_valid_len=50)),
    ],
)
def test_training_sdpa_matches_reference(shape, kw):
    got, want = _both_sdpa({}, *_qkv(*shape), **kw)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("unroll", [False, True])
def test_bucketed_block_causal_matches_reference_and_the_full_computation(unroll):
    """tests/test_perf_opts.py's case: 8 chunks of 16 in 8 buckets."""
    q, k, v = _qkv(2, 128, 4, 2, 16)
    cfg_kw = dict(causal_block_skip=True, unroll=unroll)
    got, want = _both_sdpa(cfg_kw, q, k, v, causal=True, q_chunk=16)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    full, _ = _both_sdpa({}, q, k, v, causal=True, q_chunk=16)
    np.testing.assert_allclose(got, full, atol=2e-6, rtol=2e-6)


def test_bucketed_skip_nondivisible_chunks():
    """6 chunks of 16: the number of buckets falls back from 8 to 6."""
    q, k, v = _qkv(1, 96, 2, 2, 16, seed=3)
    got, want = _both_sdpa(dict(causal_block_skip=True), q, k, v, causal=True, q_chunk=16)
    np.testing.assert_allclose(got, want, atol=2e-6)
    full, _ = _both_sdpa({}, q, k, v, causal=True, q_chunk=16)
    np.testing.assert_allclose(got, full, atol=2e-6)


def test_training_sdpa_refuses_a_ragged_chunking():
    cfg = get_config("minitron-4b", smoke=True)
    q, k, v = map(torch.from_numpy, _qkv(1, 40, 2, 2, 16))
    with pytest.raises(ValueError, match="q_chunk"):
        layers._sdpa_heads(cfg, q, k, v, causal=True, q_chunk=16)


def test_q_chunked_loss_and_gradients_match_reference():
    """A model whose sequence is several query chunks, with the bucketed skip."""
    overrides = dict(dtype="float32", causal_block_skip=True)
    jcfg = jax_get_config("chatglm3-6b", smoke=True).replace(**overrides)
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init_values(KEY))
    batch = jax.tree.map(np.asarray, _batch(jcfg, S=64))
    jm = jax_build_model(jcfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b, RULES, q_chunk=16)[0]))
    loss, grads = fn(params, batch)
    cfg = get_config("chatglm3-6b", smoke=True).replace(**overrides)
    got_loss, _, got_grads = port_grads(cfg, params, batch, q_chunk=16)
    np.testing.assert_allclose(got_loss, float(loss), rtol=LOSS_RTOL)
    check_grads(got_grads, grads)


# ------------------------------ the bf16 loss, remat ------------------------------


def _minitron(**overrides):
    jcfg = jax_get_config("minitron-4b", smoke=True).replace(**overrides)
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init_values(KEY))
    toks = np.asarray(jax.random.randint(KEY, (2, 32), 0, jcfg.vocab_size))
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    return jcfg, get_config("minitron-4b", smoke=True).replace(**overrides), params, batch


def test_bf16_loss_path_matches_reference_and_f32():
    """tests/test_perf_opts.py's case: float32 logits through the bf16 loss's path (max
    subtracted, exponentiated, summed in float32) against the reference's, and within
    5 % of the float32 loss."""
    jcfg, cfg, params, batch = _minitron(dtype="float32", softmax_dtype="bfloat16")
    loss, metrics, grads = reference_grads(jcfg, params, batch)
    got_loss, got_metrics, got_grads = port_grads(cfg, params, batch)
    np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_metrics["z_loss"], metrics["z_loss"], rtol=LOSS_RTOL)
    check_grads(got_grads, grads)
    l32, _, _ = port_grads(cfg.replace(softmax_dtype="float32"), params, batch)
    assert abs(l32 - got_loss) < 0.05 * l32


# bfloat16 at the families' bar (tests/test_torch_families.py): the loss within 4 bf16
# ulps of its value, each gradient leaf within 4 ulps of its largest |gradient|. The
# layers of both packages round the same bf16 products, but in other orders, and
# repro's bf16 elementwise functions round each step (ROADMAP R5, R11).
BF16_ULPS = 4 * 2.0**-7


@pytest.mark.parametrize("softmax_dtype", ["float32", "bfloat16"])
def test_bf16_training_near_reference(softmax_dtype):
    """The config's own bfloat16 with float32 parameters cast at use: the gradients of
    both packages are float32 sums of bf16 products."""
    jcfg, cfg, params, batch = _minitron(softmax_dtype=softmax_dtype)
    loss, _, grads = reference_grads(jcfg, params, batch)
    got_loss, _, got_grads = port_grads(cfg, params, batch)
    np.testing.assert_allclose(got_loss, loss, rtol=BF16_ULPS)
    for leaf in jax.tree.leaves(got_grads):
        assert leaf.dtype == np.float32 and np.isfinite(leaf).all()
    check_grads(got_grads, grads, tol=BF16_ULPS)


@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-130m", "seamless-m4t-large-v2"])
def test_remat_changes_memory_not_numbers(arch):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    batch = port_batch(jax.tree.map(np.asarray, _batch(cfg)))
    out = []
    for remat in ("full", "none"):
        g = torch.Generator().manual_seed(0)
        m = build_model(cfg.replace(remat=remat), "cpu", g, trainable=True)
        loss, _ = m.loss(batch)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in m.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ------------------------------ MoE and SSD under autograd ------------------------------


@pytest.mark.parametrize("T,E,k,C", [(16, 4, 2, 3), (24, 8, 2, 2), (12, 4, 1, 1)])
def test_moe_group_gradient_is_zero_at_a_dropped_slot(T, E, k, C):
    """Dropped slots write the sentinel place E * C, which is cut off: their weights'
    gradient is zero, as the reference's mode="drop" write gives."""
    rng = np.random.default_rng(T + E)
    token_e = rng.integers(0, E, T * k).astype(np.int32)
    token_w = rng.uniform(0.1, 1.0, T * k).astype(np.float32)
    r = rng.standard_normal((E, C)).astype(np.float32)

    def jloss(w):
        return jnp.sum(jax_moe._group(jnp.asarray(token_e), w, T, E, C)[1] * r)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(token_w)))
    w = torch.from_numpy(token_w).requires_grad_(True)
    _, w_of_slot, slot = moe._group(torch.from_numpy(token_e).long(), w, T, E, C)
    (w_of_slot * torch.from_numpy(r)).sum().backward()
    dropped = (slot == E * C).numpy()
    assert dropped.any() and not dropped.all()
    assert not w.grad.numpy()[dropped].any()
    np.testing.assert_array_equal(w.grad.numpy(), want)


def test_moe_aux_loss_carries_its_gradient():
    cfg = get_config("olmoe-1b-7b", smoke=True).replace(dtype="float32")
    jcfg = jax_get_config("olmoe-1b-7b", smoke=True).replace(dtype="float32")
    logits = np.random.default_rng(5).standard_normal((32, cfg.n_experts)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jax_moe._route(jcfg, x)[2])(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    moe._route(cfg, x)[2].backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-7)


def test_ssd_gradients_are_finite_with_long_decays_and_match_reference():
    """Large dt·|A| over a chunk of 64: the masked exponents overflow unless zeroed
    before exp, and the outer where's backward would then give inf * 0 = NaN."""
    cfg = get_config("mamba2-130m", smoke=True).replace(dtype="float32", ssd_chunk=64)
    jcfg = jax_get_config("mamba2-130m", smoke=True).replace(dtype="float32", ssd_chunk=64)
    rng = np.random.default_rng(11)
    B, S, H, P, G, N = 1, 128, 2, 8, 1, 4
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (20 * np.log1p(np.exp(rng.standard_normal((B, S, H))))).astype(np.float32)
    A = (-10 * np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm, Cm = (0.5 * rng.standard_normal((B, S, G, N)).astype(np.float32) for _ in range(2))
    args = (xh, dt, A, Bm, Cm)

    def jloss(*a):
        y, s = jax_mamba.ssd_chunked(jcfg, *a)
        return jnp.sum(y) + jnp.sum(s)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = mamba.ssd_chunked(cfg, *ts)
    (y.sum() + st.sum()).backward()
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)


# ------------------------------ StepBuilder.train_step ------------------------------


@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-130m", "olmoe-1b-7b"])
def test_microbatched_adamw_steps_match_reference(arch):
    """Three steps of 2 microbatches with a schedule and a clip, on the same weights and
    TokenPipeline batches: the metrics within 1e-5 relative; the parameters, and each
    AdamW moment, as one vector within 1e-5 of the reference's in norm, and leaf by
    leaf within 1e-4. Not element by element: AdamW divides by sqrt(v) + 1e-8, so
    where |g| is small the two packages' float32 gradient rounding moves an element
    by a good part of lr (ROADMAP R13), and in olmoe's 3-step run the embedding table
    sits 1.01e-5 from the reference's in norm."""
    jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
    jsb = JStepBuilder(
        jcfg,
        RULES,
        n_microbatches=2,
        opt=JAdamWConfig(lr=jax_warmup_cosine(1e-2, 2, 10), clip_norm=0.5),
    )
    params = jax.tree.map(np.asarray, jsb.model.init_values(KEY))
    opt_state = jadamw.init(params)
    step_fn = jax.jit(jsb.train_step_fn())
    sb = StepBuilder(
        get_config(arch, smoke=True).replace(dtype="float32"),
        n_microbatches=2,
        opt=AdamWConfig(lr=warmup_cosine(1e-2, 2, 10), clip_norm=0.5),
        device="cpu",
    )
    sb.model.load_numpy(params)
    jpipe = JTokenPipeline(jcfg.vocab_size, 32, 4, seed=1)
    pipe = TokenPipeline(jcfg.vocab_size, 32, 4, seed=1, device="cpu")
    for i in range(3):
        params, opt_state, metrics = step_fn(params, opt_state, jpipe.batch(i))
        got = sb.train_step(pipe.batch(i))
        assert set(got) == set(metrics)  # nll, z_loss, moe_aux, loss, grad_norm, lr
        for k, v in metrics.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-8)
    assert int(sb.opt_state.step) == int(opt_state.step) == 3
    for got, want in (
        (sb.model.to_numpy(), params),
        (sb.model.to_numpy(sb.opt_state.mu), opt_state.mu),
        (sb.model.to_numpy(sb.opt_state.nu), opt_state.nu),
    ):
        flat_g = np.concatenate([g.ravel() for g in jax.tree.leaves(got)])
        flat_w = np.concatenate([np.asarray(w).ravel() for w in jax.tree.leaves(want)])
        assert np.linalg.norm(flat_g - flat_w) <= 1e-5 * np.linalg.norm(flat_w)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
            w = np.asarray(w)
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= 1e-4, f"{jax.tree_util.keystr(path)}: {err:.3e}"
