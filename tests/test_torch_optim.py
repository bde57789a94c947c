"""The port's optimizer, gradient accumulation and gradient compression against the
JAX package's (tests/test_optim.py's cases, each run through both packages on the
same numpy inputs).

AdamW's arithmetic is the reference's in its order, so its state and parameters
agree to float32 rounding (1e-6 relative); the int8 compression is bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax.numpy as jnp
import numpy as np

import repro.optim as jopt
from repro.distributed import compression as jcompression
from repro.optim import adamw as jadamw
from repro_torch.distributed import compression
from repro_torch.optim import (
    AdamWConfig,
    adamw,
    constant,
    global_norm,
    microbatched_value_and_grad,
    warmup_cosine,
)

RTOL = 1e-6


def _t(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_optim_exports_match_reference():
    import repro_torch.optim as opt

    assert opt.__all__ == jopt.__all__


def test_adamw_first_step_matches_closed_form():
    kw = dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, clip_norm=None)
    p = {"w": np.array([1.0, -2.0], np.float32)}
    g = {"w": np.array([0.5, 0.5], np.float32)}
    params = _t(p)
    st = adamw.init(params)
    new_p, st2, m = adamw.update(AdamWConfig(**kw), _t(g), st, params)
    assert new_p is params  # in place, as the reference's donated buffers
    # bias-corrected first step: mhat = g, vhat = g^2 -> step = g/|g| = sign(g)
    np.testing.assert_allclose(new_p["w"].numpy(), p["w"] - 0.1 * np.sign(g["w"]), atol=1e-5)
    assert int(st2.step) == 1 and st2.step.dtype == torch.int32
    ref, _, _ = jadamw.update(jadamw.AdamWConfig(**kw), _j(g), jadamw.init(_j(p)), _j(p))
    np.testing.assert_allclose(new_p["w"].numpy(), np.asarray(ref["w"]), rtol=RTOL)


def test_adamw_converges_on_quadratic():
    p0 = {"w": np.array([5.0, -3.0, 2.0], np.float32)}
    target = np.ones(3, np.float32)
    p, st = _t(p0), adamw.init(_t(p0))
    jp = _j(p0)
    jst = jadamw.init(jp)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    jcfg = jadamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    for _ in range(300):
        p, st, _ = adamw.update(cfg, {"w": 2 * (p["w"] - 1)}, st, p)
        jp, jst, _ = jadamw.update(jcfg, {"w": 2 * (jp["w"] - 1)}, jst, jp)
    np.testing.assert_allclose(p["w"].numpy(), target, atol=1e-2)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), atol=1e-5)


def test_grad_clipping():
    p = {"w": np.zeros(4, np.float32)}
    g = {"w": np.full(4, 100.0, np.float32)}
    params = _t(p)
    grads = _t(g)
    _, _, m = adamw.update(AdamWConfig(lr=0.1, clip_norm=1.0), grads, adamw.init(params), params)
    assert float(m["grad_norm"]) > 100  # reported norm is pre-clip
    assert np.array_equal(grads["w"].numpy(), g["w"])  # the caller's gradients stay
    ref, _, jm = jadamw.update(jadamw.AdamWConfig(lr=0.1), _j(g), jadamw.init(_j(p)), _j(p))
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(ref["w"]), rtol=RTOL)
    assert float(m["grad_norm"]) == float(jm["grad_norm"])


def _tree(rng):
    return {
        "embed": rng.standard_normal((32, 8)).astype(np.float32),
        "blocks": rng.standard_normal((2, 8, 8)).astype(np.float32) * 0.1,
        "norm": np.ones(8, np.float32),
    }


@pytest.mark.parametrize("clip_norm", [None, 1.0, 0.05])
def test_adamw_steps_with_a_schedule_and_a_clip_match_reference(clip_norm):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}]
    for _ in range(5):
        grads.append({k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()})
    params, jparams = _t(p0), _j(p0)
    st, jst = adamw.init(params), jadamw.init(jparams)
    cfg = AdamWConfig(lr=warmup_cosine(3e-2, 2, 6), clip_norm=clip_norm)
    jcfg = jadamw.AdamWConfig(lr=jopt.warmup_cosine(3e-2, 2, 6), clip_norm=clip_norm)
    for g in grads:
        params, st, m = adamw.update(cfg, _t(g), st, params)
        jparams, jst, jm = jadamw.update(jcfg, _j(g), jst, jparams)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL)
    assert int(st.step) == int(jst.step) == len(grads)
    # elementwise within 1e-6 of each leaf's largest value: with a clip the scale can sit
    # an ulp from the reference's (the norm's sum order), and b1 m + (1 - b1) g cancels
    # to a few ulps of a small moment
    for k in p0:
        for got, want in ((params, jparams), (st.mu, jst.mu), (st.nu, jst.nu)):
            want = np.asarray(want[k])
            bar = RTOL * np.abs(want).max()
            np.testing.assert_allclose(got[k].numpy(), want, rtol=RTOL, atol=bar)


def test_global_norm_matches_reference():
    t = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(float(global_norm(_t(t))), float(jopt.global_norm(_j(t))), rtol=RTOL)


def test_microbatched_grads_match_full_batch():
    rng = np.random.default_rng(0)
    w = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal(16).astype(np.float32)

    def loss(params, batch):
        pred = batch["x"] @ params["w"]
        value = ((pred - batch["y"]) ** 2).mean()
        return value, {"l": value}

    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    params = {"w": torch.from_numpy(w.copy()).requires_grad_(True)}
    (l1, _), g1 = microbatched_value_and_grad(loss, 1)(params, batch)
    g1 = g1["w"].clone()
    (l4, m4), g4 = microbatched_value_and_grad(loss, 4)(params, batch)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), g4["w"].numpy(), rtol=1e-4)
    assert g4["w"] is params["w"].grad and float(m4["l"]) == float(l4)

    def jloss(p, b):
        value = jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
        return value, {"l": value}

    (jl4, _), jg4 = jopt.microbatched_value_and_grad(jloss, 4)(
        {"w": jnp.asarray(w)}, {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    )
    np.testing.assert_allclose(float(l4), float(jl4), rtol=RTOL)
    np.testing.assert_allclose(g4["w"].numpy(), np.asarray(jg4["w"]), rtol=1e-5, atol=1e-7)


def test_microbatches_must_divide_the_batch():
    params = {"w": torch.zeros(2, requires_grad=True)}
    fn = microbatched_value_and_grad(lambda p, b: ((b["x"] @ p["w"]).sum(), {}), 3)
    with pytest.raises(ValueError, match="microbatches"):
        fn(params, {"x": torch.zeros(4, 2)})


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal(256).astype(np.float32),
        "b": rng.standard_normal((32, 32)).astype(np.float32),
    }


def test_compression_roundtrip_error_bounded():
    g = _grads(2)
    q, _ = compression.compress_grads(_t(g), compression.init(_t(g)))
    deq = compression.decompress_grads(q)
    for k in g:
        scale = float(np.abs(g[k]).max()) / 127
        err = float((deq[k] - torch.from_numpy(g[k])).abs().max())
        assert err <= scale * 0.51 + 1e-6


@pytest.mark.parametrize("seed", [2, 3])
def test_compression_int8_equals_reference_bit_for_bit(seed):
    """Two rounds, so that the residual the first leaves feeds the second."""
    st, jst = compression.init(_t(_grads(seed))), jcompression.init(_j(_grads(seed)))
    for r in range(2):
        g = _grads(seed + 10 * r)
        q, st = compression.compress_grads(_t(g), st)
        jq, jst = jcompression.compress_grads(_j(g), jst)
        for k in g:
            assert q[k][0].dtype == torch.int8
            np.testing.assert_array_equal(q[k][0].numpy(), np.asarray(jq[k][0]))
            assert float(q[k][1]) == float(jq[k][1])
            np.testing.assert_array_equal(st.residual[k].numpy(), np.asarray(jst.residual[k]))


def test_quantize_rounds_half_to_even_as_reference():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, 64.5], np.float32)
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcompression.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_error_feedback_sgd_converges():
    """EF-int8-compressed SGD still reaches the optimum (error feedback works), on the
    reference's trajectory."""
    target = np.array([2.0, -1.0, 0.5, 3.0], np.float32)
    w, jw = torch.zeros(4), jnp.zeros(4)
    st, jst = compression.init({"w": w}), jcompression.init({"w": jw})
    for _ in range(400):
        q, st = compression.compress_grads({"w": 2 * (w - torch.from_numpy(target))}, st)
        w = w - 0.05 * compression.decompress_grads(q)["w"]
        jq, jst = jcompression.compress_grads({"w": 2 * (jw - target)}, jst)
        jw = jw - 0.05 * jcompression.decompress_grads(jq)["w"]
    np.testing.assert_allclose(w.numpy(), target, atol=5e-2)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)


def test_warmup_cosine_schedule():
    s = warmup_cosine(1.0, 10, 100)
    assert float(s(torch.tensor(0))) == 0.0
    assert abs(float(s(torch.tensor(10))) - 1.0) < 1e-6
    assert float(s(torch.tensor(100))) <= 0.11
    assert float(s(torch.tensor(55))) < float(s(torch.tensor(20)))


@pytest.mark.parametrize("args", [(1.0, 10, 100), (6e-4, 50, 300), (3e-3, 0, 7), (0.5, 3, 3)])
def test_schedules_match_reference(args):
    s, js = warmup_cosine(*args), jopt.warmup_cosine(*args)
    steps = np.arange(0, args[2] + 12, dtype=np.int32)
    got = np.array([float(s(torch.tensor(int(i), dtype=torch.int32))) for i in steps])
    want = np.array([float(js(jnp.asarray(i))) for i in steps])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    c = constant(args[0])(torch.tensor(3))
    assert c.dtype == torch.float32 and float(c) == float(jopt.constant(args[0])(jnp.asarray(3)))
