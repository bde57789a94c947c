"""Reference runs and checks shared by the LM parity tests (``test_torch_lm.py`` for the
dense family, ``test_torch_families.py`` for the MoE, SSM and hybrid families).

Weights move across as the reference's ``init_values`` tree in numpy
(``Model.from_numpy``); prompts are numpy draws from a seed. ``carried_fixture(archs)``
makes a module-scoped fixture that runs the jitted reference calls once per
architecture, so each test file shares them across its tests.
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


def reference_run(arch):
    """One architecture's reference run on shared weights and prompts: prefill of the
    first S - 1 tokens, one decode step on the padded cache, a greedy loop of N_GREEDY
    tokens, and prefill of all S tokens in the config's own bf16 (with its router
    logits, MoE layer by MoE layer, and the float32 prefill of all S tokens)."""
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
    _, logits_f32 = prefill(params, toks)
    bf16 = jax_build_model(jax_get_config(arch, smoke=True))
    router = []
    route = jax_moe._route

    def record(a):
        router.append(np.asarray(a, np.float32))

    def recording_route(cfg, logits):
        jax.debug.callback(record, logits, ordered=True)
        return route(cfg, logits)

    jax_moe._route = recording_route
    try:
        prefill_bf16 = jax.jit(lambda p, t: bf16.prefill(p, {"tokens": t}, RULES))
        _, logits_bf16 = prefill_bf16(params, toks)
        jax.effects_barrier()
    finally:
        jax_moe._route = route
    return dict(
        arch=arch,
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
    """A module-scoped fixture ``carried`` over ``archs``: ``reference_run`` of each."""

    @pytest.fixture(scope="module", params=archs)
    def carried(request):
        return reference_run(request.param)

    return carried


def check_prefill_and_decode(carried):
    """Prefill logits, every cache entry (attention k and v up to the prompt's length,
    zero beyond it; SSM conv window and state) and one decode step's logits, within
    TOL of the reference."""
    model = Model.from_numpy(f32(carried["arch"]), carried["params"], "cpu")
    toks = torch.from_numpy(carried["toks"]).long()
    cache = model.init_cache(B, S - 1 + N_GREEDY)
    cache, logits = model.prefill(toks[:, : S - 1], cache)
    np.testing.assert_allclose(logits.numpy(), carried["logits"], atol=TOL, rtol=TOL)
    assert len(cache) == len(carried["cache"])
    for got, want in zip(cache, carried["cache"]):
        assert got.keys() == want.keys()
        for kind in got:
            assert got[kind].keys() == want[kind].keys()
            for name, t in got[kind].items():
                if kind == "attn":
                    assert not t[..., S - 1 :, :].any()  # not written yet
                    t = t[..., : S - 1, :]
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), want[kind][name], atol=TOL, rtol=TOL)
    _, logits_dec = model.decode_step(cache, toks[:, S - 1 :], S - 1)
    np.testing.assert_allclose(logits_dec.numpy(), carried["logits_dec"], atol=TOL, rtol=TOL)


def check_greedy(carried):
    model = Model.from_numpy(f32(carried["arch"]), carried["params"], "cpu")
    toks = torch.from_numpy(carried["toks"][:, : S - 1]).long()
    cache, logits = model.prefill(toks, model.init_cache(B, S - 1 + N_GREEDY))
    out = serve.decode_greedy(model, cache, logits, S - 1, N_GREEDY)
    np.testing.assert_array_equal(out.numpy(), carried["greedy"])


def check_decode_matches_prefill(cfg):
    """decode(prefill(x[:-1]), x[-1]) == prefill(x) at the last token, at
    tests/test_models_smoke.py's bar."""
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)))
    _, full = model.prefill(toks)
    cache, _ = model.prefill(toks[:, :-1], model.init_cache(2, 32))
    _, dec = model.decode_step(cache, toks[:, -1:], 31)
    np.testing.assert_allclose(full.numpy(), dec.numpy(), atol=2e-4, rtol=2e-3)
