"""The port's LM serving path (configs, layers, the dense family through the block
engine, the model and ``launch/serve.py``) against the JAX package, on the CPU.

Weights move across as the reference's ``init_values`` tree in numpy
(``Model.from_numpy``); prompts are numpy draws from a seed. The reference calls are
jitted and shared per architecture through a module-scoped fixture
(``torch_lm_cases.carried_fixture``); ``test_torch_families.py`` runs the other
families through the same fixture.
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
from repro.launch.serve import decode_flops_bytes as jax_decode_flops_bytes
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, model_flops, shape_applicable
from repro_torch.launch import serve
from repro_torch.models import Model, build_model
from repro_torch.models import layers
from torch_lm_cases import (
    RULES,
    carried_fixture,
    check_decode_matches_prefill,
    check_greedy,
    check_prefill_and_decode,
    f32,
)

CARRIED = ["minitron-4b", "chatglm3-6b", "granite-20b"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------ configs -------------------------------------


# the port's archs that the JAX package does not have (tests/test_torch_granite.py)
PORT_ONLY = ["granite-4.0-h-small"]


def test_configs_match_reference():
    assert JAX_ARCH_IDS == [a for a in ARCH_IDS if a not in PORT_ONLY]
    for arch in JAX_ARCH_IDS:
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
    for arch in JAX_ARCH_IDS:
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

carried = carried_fixture(CARRIED)


def test_prefill_and_decode_match_reference(carried):
    check_prefill_and_decode(carried)


def test_greedy_tokens_match_reference(carried):
    check_greedy(carried)


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
    check_decode_matches_prefill(f32(arch))


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


def test_generate_on_cpu():
    r = serve.generate("minitron-4b", batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    assert r.tokens.shape == (2, 4) and r.tokens.dtype == np.int64
    assert (0 <= r.tokens).all() and (r.tokens < 512).all()
    assert r.prefill_s > 0 and r.decode_s > 0 and r.tokens_per_s > 0
    again = serve.generate("minitron-4b", batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    np.testing.assert_array_equal(again.tokens, r.tokens)
