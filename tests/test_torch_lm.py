"""The port's LM serving path (configs, layers, the dense block engine, the model and
``launch/serve.py``) against the JAX package, on the CPU.

Weights move across as the reference's ``init_values`` tree in numpy
(``Model.from_numpy``); prompts are numpy draws from a seed. The reference calls are
jitted and shared per architecture through a module-scoped fixture.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import model_flops as jax_model_flops
from repro.configs import shape_applicable as jax_shape_applicable
from repro.distributed import is_box, make_rules
from repro.launch.serve import decode_flops_bytes as jax_decode_flops_bytes
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, model_flops, shape_applicable
from repro_torch.launch import serve
from repro_torch.models import Model, build_model
from repro_torch.models import layers

RULES = make_rules(None)
CARRIED = ["minitron-4b", "chatglm3-6b", "granite-20b"]
NOT_PORTED = [
    "olmoe-1b-7b",
    "granite-moe-3b-a800m",
    "mamba2-130m",
    "jamba-v0.1-52b",
    "seamless-m4t-large-v2",
]
B, S, N_GREEDY = 2, 16, 8
# Prefill and decode of the same weights in float32: the two packages sum in other
# orders (about 2.5e-6 seen on logits of size ~4), so 1e-4 absolute and relative.
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------ configs -------------------------------------


def test_configs_match_reference():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            port, ref = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), (arch, smoke)
            assert (port.d_inner, port.ssm_nheads) == (ref.d_inner, ref.ssm_nheads)
            assert [port.is_attn_layer(i) for i in range(port.n_layers)] == [
                ref.is_attn_layer(i) for i in range(ref.n_layers)
            ]
            assert [port.is_moe_layer(i) for i in range(port.n_layers)] == [
                ref.is_moe_layer(i) for i in range(ref.n_layers)
            ]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()
    }
    assert get_config("minitron-4b").replace(dtype="float32").dtype == "float32"


def test_counts_match_reference():
    assert get_config("minitron-4b").param_counts()["total"] == 4_190_109_696
    for arch in ARCH_IDS:
        for smoke in (False, True):
            port, ref = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
            assert port.param_counts() == ref.param_counts()
            for name in SHAPES:
                ok = shape_applicable(port, SHAPES[name])
                assert ok == jax_shape_applicable(ref, JAX_SHAPES[name])
                if ok[0]:
                    assert model_flops(port, SHAPES[name]) == jax_model_flops(ref, JAX_SHAPES[name])
            for batch, ctx in ((1, 512), (128, 32_768)):
                got = serve.decode_flops_bytes(port, batch, ctx)
                assert got == jax_decode_flops_bytes(ref, batch, ctx)


# ------------------------------ layers --------------------------------------

# Layer functions in float32 on the same inputs: one or two roundings apart.
LAYER_TOL = 1e-6


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norm_matches_reference(norm):
    cfg = get_config("minitron-4b", smoke=True).replace(norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    ref = jl.apply_norm(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    mod = layers.Norm(cfg, 64, "cpu")
    for k, v in p.items():
        getattr(mod, k).copy_(_t(v))
    np.testing.assert_allclose(mod(_t(x)).numpy(), np.asarray(ref), atol=LAYER_TOL, rtol=LAYER_TOL)


def test_qk_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    ref = jl.rms_norm_nohead(jnp.asarray(x), jnp.asarray(scale))
    out = layers.rms_norm_nohead(_t(x), _t(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_reference(fraction):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    for positions in (np.arange(7), np.array([[300]])):
        xs = x if positions.ndim == 1 else x[:, :1]
        ref = jl.apply_rope(jnp.asarray(xs), jnp.asarray(positions), 10_000.0, fraction)
        out = layers.apply_rope(_t(xs), _t(positions), 10_000.0, fraction)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LAYER_TOL, rtol=LAYER_TOL)
    if fraction == 0.5:  # the second half of each head passes through
        np.testing.assert_array_equal(out.numpy()[..., 8:], xs[..., 8:])


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_mlp_matches_reference(mlp_type):
    cfg = get_config("minitron-4b", smoke=True).replace(mlp_type=mlp_type, dtype="float32")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {
        "w_up": rng.standard_normal((64, 192)).astype(np.float32) / 8,
        "w_down": rng.standard_normal((192, 64)).astype(np.float32) / 14,
    }
    if mlp_type == "swiglu":
        p["w_gate"] = rng.standard_normal((64, 192)).astype(np.float32) / 8
    ref = jl.apply_mlp(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), RULES)
    mod = layers.MLP(cfg, "cpu")
    for k, v in p.items():
        getattr(mod, k).copy_(_t(v))
    out = mod(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=LAYER_TOL, rtol=LAYER_TOL)


# ------------------------------ the serving path ----------------------------


def _f32(arch):
    return get_config(arch, smoke=True).replace(dtype="float32")


@pytest.fixture(scope="module", params=CARRIED)
def carried(request):
    """One architecture's reference run on shared weights and prompts: prefill of the
    first S - 1 tokens, one decode step on the padded cache, a greedy loop of N_GREEDY
    tokens, and prefill of all S tokens in the config's own bf16."""
    arch = request.param
    jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
    jm = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, jm.init_values(jax.random.PRNGKey(1)))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, RULES))
    decode = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, RULES))
    cache, logits = prefill(params, toks[:, : S - 1])
    specs = jm.cache_specs(B, S - 1 + N_GREEDY)
    padded = jax.tree.map(
        lambda c, sp: jnp.pad(c, [(0, t - s) for s, t in zip(c.shape, sp.value.shape)]),
        cache,
        specs,
        is_leaf=is_box,
    )
    _, logits_dec = decode(params, padded, toks[:, S - 1 :], S - 1)
    greedy, c = [jnp.argmax(logits[:, -1], -1)], padded
    for i in range(N_GREEDY - 1):
        c, lg = decode(params, c, greedy[-1][:, None], S - 1 + i)
        greedy.append(jnp.argmax(lg[:, -1], -1))
    bf16 = jax_build_model(jax_get_config(arch, smoke=True))
    _, logits_bf16 = jax.jit(lambda p, t: bf16.prefill(p, {"tokens": t}, RULES))(params, toks)
    return dict(
        arch=arch,
        params=params,
        toks=toks,
        cache=jax.tree.map(np.asarray, cache),
        logits=np.asarray(logits),
        logits_dec=np.asarray(logits_dec),
        greedy=np.stack([np.asarray(g) for g in greedy], 1),
        logits_bf16=np.asarray(logits_bf16, np.float32),
    )


def test_prefill_and_decode_match_reference(carried):
    model = Model.from_numpy(_f32(carried["arch"]), carried["params"], "cpu")
    toks = torch.from_numpy(carried["toks"]).long()
    cache = model.init_cache(B, S - 1 + N_GREEDY)
    cache, logits = model.prefill(toks[:, : S - 1], cache)
    np.testing.assert_allclose(logits.numpy(), carried["logits"], atol=TOL, rtol=TOL)
    for name in ("k", "v"):
        got = cache[0]["attn"][name][..., : S - 1, :].numpy()
        np.testing.assert_allclose(got, carried["cache"][0]["attn"][name], atol=TOL, rtol=TOL)
        assert not cache[0]["attn"][name][..., S - 1 :, :].any()  # not written yet
    _, logits_dec = model.decode_step(cache, toks[:, S - 1 :], S - 1)
    np.testing.assert_allclose(logits_dec.numpy(), carried["logits_dec"], atol=TOL, rtol=TOL)


def test_greedy_tokens_match_reference(carried):
    model = Model.from_numpy(_f32(carried["arch"]), carried["params"], "cpu")
    toks = torch.from_numpy(carried["toks"][:, : S - 1]).long()
    cache, logits = model.prefill(toks, model.init_cache(B, S - 1 + N_GREEDY))
    out = serve.decode_greedy(model, cache, logits, S - 1, N_GREEDY)
    np.testing.assert_array_equal(out.numpy(), carried["greedy"])


def test_bf16_prefill_is_near_reference(carried):
    """The config's own bfloat16. The reference's plain attention rounds the scores
    and the softmax weights to bf16 (models/layers.py:194, :207); the port's attention
    (the flash kernel's function) keeps both in float32 and rounds only its output,
    so the two differ by construction (ROADMAP, R5): about 1.4 bf16 ulps of the
    largest logit were seen. The bar is 4 ulps (2^-7 relative each) of it."""
    cfg = get_config(carried["arch"], smoke=True)
    model = Model.from_numpy(cfg, carried["params"], "cpu")
    assert model.blocks[0].mixer.wq.dtype == torch.bfloat16
    assert model.blocks[0].norm1.scale.dtype == torch.float32
    _, logits = model.prefill(torch.from_numpy(carried["toks"]).long())
    assert logits.dtype == torch.bfloat16
    ref = carried["logits_bf16"]
    err = np.abs(logits.float().numpy() - ref).max()
    assert err <= 4 * 2**-7 * np.abs(ref).max(), err


# ------------------------------ the port's own properties ------------------


@pytest.mark.parametrize("arch", CARRIED + ["nemotron-4-15b", "chameleon-34b"])
def test_decode_matches_prefill(arch):
    """decode(prefill(x[:-1]), x[-1]) == prefill(x) at the last token, at
    tests/test_models_smoke.py's bar; this holds the prefill attention (the flash
    kernel's path) against the plain decode attention."""
    cfg = _f32(arch)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)))
    _, full = model.prefill(toks)
    cache, _ = model.prefill(toks[:, :-1], model.init_cache(2, 32))
    _, dec = model.decode_step(cache, toks[:, -1:], 31)
    np.testing.assert_allclose(full.numpy(), dec.numpy(), atol=2e-4, rtol=2e-3)


def test_to_numpy_round_trips():
    cfg = get_config("chameleon-34b", smoke=True)  # qk-norm, bf16 weights
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    tree = model.to_numpy()
    assert set(tree) == {"embed", "final_norm", "blocks"} and len(tree["blocks"]) == 1
    assert tree["blocks"][0]["mixer"]["wq"].shape == (2, 64, 4, 16)
    assert tree["blocks"][0]["mixer"]["q_norm"].dtype == np.float32
    again = Model.from_numpy(cfg, tree, "cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    jtree = jax_build_model(jax_get_config("chameleon-34b", smoke=True)).init_values(
        jax.random.PRNGKey(0)
    )
    shapes = jax.tree.map(lambda a: a.shape, jtree)
    assert jax.tree.map(lambda a: a.shape, tree) == shapes


def test_init_follows_the_reference_scheme():
    cfg = get_config("minitron-4b", smoke=True).replace(d_model=256, d_ff=512, n_layers=1)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    mix = model.blocks[0].mixer
    # dense_init: std = 1 / sqrt(fan_in), fan_in = d for wq and H * hd for wo
    assert mix.wq.float().std().item() == pytest.approx(256**-0.5, rel=0.05)
    assert mix.wo.float().std().item() == pytest.approx(64**-0.5, rel=0.05)
    assert model.embed.tok.float().std().item() == pytest.approx(512**-0.5, rel=0.05)
    assert torch.equal(model.final_norm.scale, torch.ones(256))
    assert not model.blocks[0].norm1.bias.any()
    again = build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    assert torch.equal(again.embed.unembed, model.embed.unembed)


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_families_not_ported_raise(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.generate(arch, device="cpu")


def test_generate_on_cpu():
    r = serve.generate("minitron-4b", batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    assert r.tokens.shape == (2, 4) and r.tokens.dtype == np.int64
    assert (0 <= r.tokens).all() and (r.tokens < 512).all()
    assert r.prefill_s > 0 and r.decode_s > 0 and r.tokens_per_s > 0
    again = serve.generate("minitron-4b", batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    np.testing.assert_array_equal(again.tokens, r.tokens)
