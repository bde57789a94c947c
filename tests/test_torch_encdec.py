"""The enc-dec family (seamless-m4t-large-v2) through the port's layers, block engine,
model and ``launch/serve.py``, against the JAX package on the CPU, at smoke size with
the reference's weights carried across (``torch_lm_cases``).

The encoder runs K2's non-causal path (its plain version here), the decoder K2's
causal path, and cross-attention the plain counterpart of the reference's ``_sdpa``.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.distributed import unbox_values
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model, build_model, layers, transformer
from torch_lm_cases import (
    B,
    RULES,
    TOL,
    carried_fixture,
    carried_model,
    check_decode_matches_prefill,
    check_greedy,
    check_prefill_and_decode,
    draw_source,
    f32,
    port_source,
)

ARCH = "seamless-m4t-large-v2"
# Layer functions in float32 on the same inputs: a few roundings apart.
LAYER_TOL = 1e-5

carried = carried_fixture(
    [
        pytest.param((ARCH, {}), id="frames"),
        pytest.param((ARCH, {"source": "src_tokens"}), id="src_tokens"),
        # R10: a source shorter than enc_memory_len (48 of 64); decode attends to the
        # zero-padded cross entries as well, in both packages
        pytest.param((ARCH, {"source_len": 48}), id="short_source"),
        # R9: prefill's cross keys are k-normed, the cached ones are not
        pytest.param((ARCH, {"qk_norm": True}), id="qk_norm"),
    ]
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulp(a):
    """bf16's spacing at each |a| (normal range)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0**-126))) - 7)


# ------------------------------ sinusoidal positions ------------------------


@pytest.mark.parametrize("dim", [64, 1024])
def test_sinusoidal_pos_emb_matches_reference(dim):
    """Positions 0-4095 (the encoder's full length). Both packages take the same
    float32 formula, but XLA's float32 ``exp`` on the CPU is not correctly rounded for
    about 12 % of the frequencies (torch's is for 99 %; ROADMAP, R12), so a frequency
    can sit one ulp off, and then its angle pos x f one ulp of the angle off (up to
    2^-12 rad below 4096). The bar per element is two ulps of the angle plus 2^-23:
    sin and cos move by at most the angle's change, each rounded once."""
    pos = np.arange(4096)
    ref = np.asarray(jl.sinusoidal_pos_emb(jnp.asarray(pos), dim, jnp.float32))
    out = layers.sinusoidal_pos_emb(torch.from_numpy(pos), dim, torch.float32).numpy()
    assert out.shape == ref.shape == (4096, dim) and out.dtype == np.float32
    half = dim // 2
    freqs = np.exp(-np.arange(half) * (np.log(10_000.0) / (half - 1)))
    ang = np.tile((pos[:, None] * freqs).astype(np.float32), 2)
    assert (np.abs(out - ref) <= 2 * np.spacing(ang) + 2.0**-23).all()
    # the first 64 positions (the smoke configs' lengths) within 1e-5
    np.testing.assert_allclose(out[:64], ref[:64], atol=1e-5, rtol=0)
    # a decode step's row equals the table's at its position, bit for bit; bf16 is a cast
    for p in (0, 1, 4095):
        row = layers.sinusoidal_pos_emb(torch.full((1,), p), dim, torch.float32)
        assert torch.equal(row[0], torch.from_numpy(out[p]))
    bf16 = layers.sinusoidal_pos_emb(torch.from_numpy(pos), dim, torch.bfloat16)
    assert torch.equal(bf16, torch.from_numpy(out).to(torch.bfloat16))


# ------------------------------ attention modes -----------------------------

VARIANTS = {
    "seamless": {},
    "qk_norm": {"qk_norm": True},
    # GQA (the cross and decode attentions repeat each KV head) and RoPE in bidir
    "gqa_rope": {"n_kv_heads": 2, "pos_emb": "rope"},
}


def _attention_case(variant, dtype="float32", seed=0):
    """Weights (the reference's init), queries x (2, 8, d), an encoder output e
    (2, 24, d), and the port's module holding the weights."""
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype, **VARIANTS[variant])
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=dtype, **VARIANTS[variant])
    p = unbox_values(jl.init_attention(jcfg, jax.random.PRNGKey(seed)))
    p = jax.tree.map(np.asarray, p)
    if jcfg.qk_norm:  # scales other than 1, so that a missing norm shows
        rng = np.random.default_rng(seed)
        p["q_norm"] = 1 + rng.standard_normal(p["q_norm"].shape).astype(np.float32) / 2
        p["k_norm"] = 1 + rng.standard_normal(p["k_norm"].shape).astype(np.float32) / 2
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    e = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    mod = layers.Attention(cfg, "cpu")
    for k, v in p.items():
        getattr(mod, k).copy_(_t(v))
    dt = getattr(jnp, dtype)
    return cfg, jcfg, p, jnp.asarray(x).astype(dt), jnp.asarray(e).astype(dt), mod


def _port(a, dtype="float32"):
    return _t(np.asarray(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", ["bidir", "cross", "cross_kv", "cross_decode"])
def test_attention_mode_matches_reference(mode, variant):
    cfg, jcfg, p, x, e, mod = _attention_case(variant)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if mode == "bidir":
        pos = jnp.arange(e.shape[1])
        ref, _ = jl.attention(jcfg, jp, e, RULES, mode="bidir", positions=pos)
        out, _ = mod(_port(e), mode="bidir", positions=torch.arange(e.shape[1]))
    elif mode == "cross":
        ref, _ = jl.attention(jcfg, jp, x, RULES, mode="cross", kv_x=e)
        cache = mod.cross_kv(_port(e))  # with a cache of 32 > 24 entries: the rest kept
        cache = {k: torch.cat([t, torch.full_like(t[:, :, :8], 7)], 2) for k, t in cache.items()}
        out, _ = mod(_port(x), mode="cross", kv_x=_port(e), cache=cache)
        assert (cache["ck"][:, :, 24:] == 7).all()
        want = jl.cross_kv(jcfg, jp, e)
        for k in ("ck", "cv"):
            np.testing.assert_allclose(cache[k][:, :, :24], want[k], atol=LAYER_TOL, rtol=0)
    elif mode == "cross_kv":
        ref = jl.cross_kv(jcfg, jp, e)
        got = mod.cross_kv(_port(e))
        assert got["ck"].shape == (2, cfg.n_kv_heads, 24, cfg.head_dim)
        for k in ("ck", "cv"):
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=LAYER_TOL, rtol=0)
        return
    else:
        kv = jl.cross_kv(jcfg, jp, e)
        ref, _ = jl.attention(jcfg, jp, x[:, :1], RULES, mode="cross_decode", cache=kv)
        cache = {k: _port(v) for k, v in kv.items()}
        out, _ = mod(_port(x[:, :1]), mode="cross_decode", cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("variant", ["seamless", "gqa_rope"])
def test_bf16_cross_attention_within_one_ulp(variant):
    """In bf16 both packages follow ``_sdpa``'s roundings (scores to bf16 then float32,
    float32 softmax, weights to bf16 before P·V); their products sum in other orders, so
    each output is held within one bf16 ulp of the reference's."""
    _, jcfg, p, x, e, mod = _attention_case(variant, "bfloat16", seed=3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref, _ = jl.attention(jcfg, jp, x, RULES, mode="cross", kv_x=e)
    out, _ = mod(_port(x, "bfloat16"), mode="cross", kv_x=_port(e, "bfloat16"))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    assert (np.abs(out.float().numpy() - ref) <= _ulp(ref)).all()


# ------------------------------ the encoder ---------------------------------


@pytest.fixture(scope="module")
def encoder_case():
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init_values(jax.random.PRNGKey(2)))
    return jcfg, params


@pytest.mark.parametrize("source", ["frames", "src_tokens"])
def test_encode_matches_reference(encoder_case, source):
    jcfg, params = encoder_case
    src = draw_source(jcfg, B, source, 40)
    ref = jax.jit(lambda p, s: jt._encode(jcfg, p, s, RULES))(params, src)
    model = Model.from_numpy(f32(ARCH), params, "cpu")
    out = transformer._encode(model, **port_source(src))
    assert out.shape == (B, 40, jcfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


# ------------------------------ the serving path ----------------------------


def test_prefill_and_decode_match_reference(carried):
    check_prefill_and_decode(carried)


def test_greedy_tokens_match_reference(carried):
    check_greedy(carried)


def test_bf16_prefill_is_near_reference(carried):
    """The config's own bfloat16. ``repro``'s bf16 rounds each step of its tanh-form
    gelu to bf16 (ROADMAP, R11) and its attention scores and weights (R5); the port's
    gelu is rounded once and K2 keeps both in float32. So what holds is the families'
    bar: the port's logits no further from the float32 reference than ``repro``'s own
    bf16 logits are, plus one ulp of the token's largest; and, in two layers, within
    R5's 4 ulps of ``repro``'s bf16 logits (1.0-1.8 seen)."""
    model, src = carried_model(carried, dtype=None)
    assert model.enc_blocks[0].mixer.wq.dtype == torch.bfloat16
    assert model.blocks[0].norm_cross.scale.dtype == torch.float32
    _, logits = model.prefill(torch.from_numpy(carried["toks"]).long(), **src)
    assert logits.dtype == torch.bfloat16
    logits = logits.float().numpy()
    ref, f32_ref = carried["logits_bf16"], carried["logits_f32"]
    top = np.abs(f32_ref).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    ours = np.abs(logits - f32_ref).max(-1, keepdims=True)
    theirs = np.abs(ref - f32_ref).max(-1, keepdims=True)
    assert (ours <= theirs + ulp).all(), (ours / ulp, theirs / ulp)
    assert (np.abs(logits - ref).max(-1, keepdims=True) <= 4 * ulp).all()


def test_decode_matches_prefill():
    """decode(prefill(x[:-1]), x[-1]) == prefill(x) at the last token with one source,
    at tests/test_models_smoke.py's bar: K2's causal prefill and the plain cross
    attention against the plain decode and cross_decode attentions."""
    check_decode_matches_prefill(f32(ARCH))


def test_block_program_and_cache_specs_match_reference():
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
        jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=dtype)
        for decoder in (True, False):
            assert transformer.block_program(cfg, decoder) == jt.block_program(jcfg, decoder)
        want = jt.cache_specs(jcfg, 3, 20)
        got = transformer.cache_specs(cfg, 3, 20)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"attn", "cross"}
            for kind in g:
                for name, (shape, dt) in g[kind].items():
                    assert shape == w[kind][name].value.shape
                    assert str(dt)[6:] == str(w[kind][name].value.dtype)
    assert got[0]["cross"]["ck"][0] == (2, 3, 4, 64, 16)  # enc_memory_len 64 entries


def test_to_numpy_round_trips():
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    tree = model.to_numpy()
    assert set(tree) == {"embed", "final_norm", "blocks", "enc_blocks", "enc_norm"}
    assert len(tree["blocks"]) == len(tree["enc_blocks"]) == 1
    assert tree["blocks"][0]["cross"]["wq"].shape == (2, 64, 4, 16)
    assert "cross" not in tree["enc_blocks"][0]
    again = Model.from_numpy(cfg, tree, "cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    jtree = jax_build_model(jax_get_config(ARCH, smoke=True)).init_values(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, tree) == jax.tree.map(lambda a: a.shape, jtree)


def test_init_follows_the_reference_scheme():
    cfg = get_config(ARCH, smoke=True).replace(d_model=256, d_ff=512, n_layers=1, n_enc_layers=1)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    enc, dec = model.enc_blocks[0], model.blocks[0]
    # dense_init: std = 1 / sqrt(fan_in): d for wq/wk/wv and w_up, H * hd for wo, d_ff
    # for w_down
    for w, fan_in in (
        (enc.mixer.wq, 256),
        (enc.mixer.wo, 64),
        (enc.ffn.w_up, 256),
        (enc.ffn.w_down, 512),
        (dec.cross.wq, 256),
        (dec.cross.wk, 256),
        (dec.cross.wv, 256),
        (dec.cross.wo, 64),
    ):
        assert w.float().std().item() == pytest.approx(fan_in**-0.5, rel=0.05)
        assert abs(w.float().mean().item()) < 0.05 * fan_in**-0.5
    assert torch.equal(model.enc_norm.scale, torch.ones(256))
    assert torch.equal(dec.norm_cross.scale, torch.ones(256))
    assert not dec.norm_cross.bias.any() and not model.enc_norm.bias.any()
    assert not torch.equal(dec.cross.wq, dec.mixer.wq)


def test_generate_on_cpu():
    r = serve.generate(ARCH, batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    assert r.tokens.shape == (2, 4) and r.tokens.dtype == np.int64
    assert (0 <= r.tokens).all() and (r.tokens < 512).all()
    assert r.prefill_s > 0 and r.decode_s > 0 and r.tokens_per_s > 0
    again = serve.generate(ARCH, batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    np.testing.assert_array_equal(again.tokens, r.tokens)


def _bad_prefill(case):
    toks = torch.zeros(1, 4, dtype=torch.long)
    frames, src = torch.zeros(1, 8, 64), torch.zeros(1, 8, dtype=torch.long)
    arch, kwargs = {
        "neither": (ARCH, {}),
        "both": (ARCH, {"frames": frames, "src_tokens": src}),
        "too_long": (ARCH, {"frames": torch.zeros(1, 65, 64)}),
        "frames_to_decoder_only": ("minitron-4b", {"frames": frames}),
        "src_tokens_to_decoder_only": ("minitron-4b", {"src_tokens": src}),
    }[case]
    model = Model(get_config(arch, smoke=True).replace(dtype="float32"), "cpu")
    return lambda: model.prefill(toks, **kwargs)


@pytest.mark.parametrize(
    "case,match",
    [
        ("neither", "exactly one of frames= and src_tokens="),
        ("both", "exactly one of frames= and src_tokens="),
        ("too_long", "a source of 65 is longer than the cross cache"),
        ("frames_to_decoder_only", "has no encoder"),
        ("src_tokens_to_decoder_only", "has no encoder"),
    ],
)
def test_prefill_keywords_raise(case, match):
    with pytest.raises(ValueError, match=match):
        _bad_prefill(case)()


def test_generate_draws_frames_after_the_prompts():
    """``generate``'s source: (B, enc_memory_len, d) normals in the working dtype, the
    generator's next draw after the prompts."""
    cfg = get_config(ARCH, smoke=True)
    g = torch.Generator().manual_seed(0)
    model = build_model(cfg, "cpu", g)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    frames = torch.randn((2, cfg.enc_memory_len, cfg.d_model), generator=g).to(torch.bfloat16)
    cache, logits = model.prefill(prompts, model.init_cache(2, 12), frames=frames)
    want = serve.decode_greedy(model, cache, logits, 8, 4).numpy()
    r = serve.generate(ARCH, batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    np.testing.assert_array_equal(r.tokens, want)
