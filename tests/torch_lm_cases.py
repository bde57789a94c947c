"""Reference runs and checks shared by the LM parity tests (``test_torch_lm.py`` for the
dense family, ``test_torch_families.py`` for the MoE, SSM and hybrid families,
``test_torch_encdec.py`` for the enc-dec family).

Weights move across as the reference's ``init_values`` tree in numpy
(``Model.from_numpy``); prompts, and an enc-dec model's source (frames or source
tokens), are numpy draws from a seed. ``carried_fixture(archs)`` makes a module-scoped
fixture that runs the jitted reference calls once per architecture, or per
(architecture, options) case, so each test file shares them across its tests.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import jax.numpy as jnp
import numpy as np

import repro.models.moe as jax_moe
from repro.configs import get_config as jax_get_config
from repro.distributed import is_box, make_rules
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model, build_model

RULES = make_rules(None)
B, S, N_GREEDY = 2, 16, 8
# Prefill and decode of the same weights in float32: the two packages sum in other
# orders (about 2.5e-6 seen on logits of size ~4), so 1e-4 absolute and relative.
TOL = 1e-4


def f32(arch, **overrides):
    return get_config(arch, smoke=True).replace(dtype="float32", **overrides)


def draw_source(cfg, batch, kind="frames", length=None, seed=3):
    """An enc-dec config's source as the reference's batch takes it: {"frames": (batch,
    length, d_model) float32 normals} or {"src_tokens": (batch, length) int32}, length
    ``enc_memory_len`` by default; {} for any other config."""
    if not cfg.encdec:
        return {}
    rng = np.random.default_rng(seed)
    length = length or cfg.enc_memory_len
    if kind == "frames":
        return {"frames": rng.standard_normal((batch, length, cfg.d_model)).astype(np.float32)}
    return {"src_tokens": rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int32)}


def port_source(source, device="cpu"):
    """``draw_source``'s arrays as the port's ``prefill`` keywords."""
    return {
        k: torch.from_numpy(a).to(device, torch.long if k == "src_tokens" else torch.float32)
        for k, a in source.items()
    }


def reference_run(arch, source="frames", source_len=None, **overrides):
    """One architecture's reference run on shared weights and prompts: prefill of the
    first S - 1 tokens, one decode step on the padded cache, a greedy loop of N_GREEDY
    tokens, and prefill of all S tokens in the config's own bf16 (with its router
    logits, MoE layer by MoE layer, and the float32 prefill of all S tokens). An enc-dec
    config encodes one source (``draw_source(cfg, B, source, source_len)``) in every
    prefill. ``overrides`` replace config fields in both dtypes."""
    jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32", **overrides)
    jm = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, jm.init_values(jax.random.PRNGKey(1)))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    src = draw_source(jcfg, B, source, source_len)
    prefill_src = jax.jit(lambda p, t, s: jm.prefill(p, {"tokens": t, **s}, RULES))

    def prefill(p, t):
        return prefill_src(p, t, src)

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
    _, logits_f32 = prefill(params, toks)
    bf16 = jax_build_model(jax_get_config(arch, smoke=True).replace(**overrides))
    router = []
    route = jax_moe._route

    def record(a):
        router.append(np.asarray(a, np.float32))

    def recording_route(cfg, logits):
        jax.debug.callback(record, logits, ordered=True)
        return route(cfg, logits)

    jax_moe._route = recording_route
    try:
        prefill_bf16 = jax.jit(lambda p, t, s: bf16.prefill(p, {"tokens": t, **s}, RULES))
        _, logits_bf16 = prefill_bf16(params, toks, src)
        jax.effects_barrier()
    finally:
        jax_moe._route = route
    return dict(
        arch=arch,
        overrides=overrides,
        source=src,
        params=params,
        toks=toks,
        cache=jax.tree.map(np.asarray, cache),
        logits=np.asarray(logits),
        logits_dec=np.asarray(logits_dec),
        greedy=np.stack([np.asarray(g) for g in greedy], 1),
        logits_f32=np.asarray(logits_f32),
        logits_bf16=np.asarray(logits_bf16, np.float32),
        router_bf16=router,
    )


def carried_fixture(archs):
    """A module-scoped fixture ``carried`` over ``archs``: ``reference_run`` of each. An
    entry is an arch name or ``pytest.param((arch, options), id=...)``, ``options``
    being ``reference_run``'s keywords."""

    @pytest.fixture(scope="module", params=archs)
    def carried(request):
        arch, options = (request.param, {}) if isinstance(request.param, str) else request.param
        return reference_run(arch, **options)

    return carried


def carried_model(carried, dtype="float32"):
    """The port's model on the CPU holding the carried weights, in ``dtype`` (None:
    the config's own), and its source keywords for ``prefill``."""
    cfg = get_config(carried["arch"], smoke=True).replace(**carried["overrides"])
    cfg = cfg.replace(dtype=dtype) if dtype else cfg
    return Model.from_numpy(cfg, carried["params"], "cpu"), port_source(carried["source"])


def check_prefill_and_decode(carried):
    """Prefill logits, every cache entry (attention k and v up to the prompt's length and
    cross-attention ck and cv up to the source's, zero beyond each; SSM conv window and
    state) and one decode step's logits, within TOL of the reference."""
    model, src = carried_model(carried)
    toks = torch.from_numpy(carried["toks"]).long()
    cache = model.init_cache(B, S - 1 + N_GREEDY)
    cache, logits = model.prefill(toks[:, : S - 1], cache, **src)
    np.testing.assert_allclose(logits.numpy(), carried["logits"], atol=TOL, rtol=TOL)
    assert len(cache) == len(carried["cache"])
    for got, want in zip(cache, carried["cache"]):
        assert got.keys() == want.keys()
        for kind in got:
            assert got[kind].keys() == want[kind].keys()
            for name, t in got[kind].items():
                if kind in ("attn", "cross"):
                    n = want[kind][name].shape[-2]  # the prompt's or the source's length
                    assert not t[..., n:, :].any()  # not written
                    t = t[..., :n, :]
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), want[kind][name], atol=TOL, rtol=TOL)
    _, logits_dec = model.decode_step(cache, toks[:, S - 1 :], S - 1)
    np.testing.assert_allclose(logits_dec.numpy(), carried["logits_dec"], atol=TOL, rtol=TOL)


def check_greedy(carried):
    model, src = carried_model(carried)
    toks = torch.from_numpy(carried["toks"][:, : S - 1]).long()
    cache, logits = model.prefill(toks, model.init_cache(B, S - 1 + N_GREEDY), **src)
    out = serve.decode_greedy(model, cache, logits, S - 1, N_GREEDY)
    np.testing.assert_array_equal(out.numpy(), carried["greedy"])


def check_decode_matches_prefill(cfg):
    """decode(prefill(x[:-1]), x[-1]) == prefill(x) at the last token, at
    tests/test_models_smoke.py's bar."""
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)))
    src = port_source(draw_source(cfg, 2))
    _, full = model.prefill(toks, **src)
    cache, _ = model.prefill(toks[:, :-1], model.init_cache(2, 32), **src)
    _, dec = model.decode_step(cache, toks[:, -1:], 31)
    np.testing.assert_allclose(full.numpy(), dec.numpy(), atol=2e-4, rtol=2e-3)
