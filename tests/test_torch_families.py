"""The MoE, SSM and hybrid families (olmoe-1b-7b, granite-moe-3b-a800m, mamba2-130m,
jamba-v0.1-52b) through the port's block engine, model and ``launch/serve.py``,
against the JAX package on the CPU, at smoke size with the reference's weights
carried across (``torch_lm_cases``).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model, build_model, moe
from torch_lm_cases import (
    B,
    carried_fixture,
    check_decode_matches_prefill,
    check_greedy,
    check_prefill_and_decode,
    f32,
)

FAMILIES = ["olmoe-1b-7b", "granite-moe-3b-a800m", "mamba2-130m", "jamba-v0.1-52b"]
ULP = 2.0**-7  # bf16's relative spacing

carried = carried_fixture(FAMILIES)


def test_prefill_and_decode_match_reference(carried):
    check_prefill_and_decode(carried)


def test_greedy_tokens_match_reference(carried):
    """At the default capacity factor, so that in the MoE family decode's collisions
    (B = 2 tokens, k = 2 of 8 experts, C = 1) drop slots in both packages alike."""
    cfg = f32(carried["arch"])
    if cfg.family == "moe":
        assert moe.capacity(cfg, B) == 1
    check_greedy(carried)


def _ulp(ref):
    """bf16's spacing at each token's largest |logit|."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max(-1))) - 7)


def test_bf16_prefill_is_near_reference(carried, monkeypatch):
    """The config's own bfloat16 (ROADMAP, R5 and R8). ``repro``'s bf16 rounds each step
    of its sigmoid (exp(-x) and 1 + exp(-x) to bf16: a third of its SiLU values are
    not the correctly rounded one) and its attention scores; the port's are correctly
    rounded. So hidden states drift about 0.45 ulps a layer apart and router logits
    up to 12.5 ulps (jamba's third MoE layer), and a top-k choice within that margin
    can flip (it does, in jamba). What holds:

    * router logits, every MoE layer and token, within 16 ulps of the token's largest;
      so the top-k sets are identical wherever the k-th/(k+1)-th margin exceeds 32;
    * where every route agrees, the last-token logits within 4 ulps of the largest
      (R5's bar), in every config of two layers;
    * always: the port's logits no further from the float32 reference than
      ``repro``'s own bf16 logits are, plus one ulp of the largest.
    """
    cfg = get_config(carried["arch"], smoke=True)
    model = Model.from_numpy(cfg, carried["params"], "cpu")
    router = []
    route = moe._route

    def recording_route(cfg, logits):
        router.append(logits.float().numpy())
        return route(cfg, logits)

    monkeypatch.setattr(moe, "_route", recording_route)
    _, logits = model.prefill(torch.from_numpy(carried["toks"]).long())
    assert logits.dtype == torch.bfloat16
    logits = logits.float().numpy()
    ref, ref32 = carried["logits_bf16"], carried["logits_f32"]
    k = cfg.n_experts_per_tok
    n_moe = sum(b.ffn_kind == "moe" for b in model.blocks)
    assert len(router) == len(carried["router_bf16"]) == n_moe
    routes_agree = True
    for got, want in zip(router, carried["router_bf16"]):
        unit = _ulp(want)
        gap = np.abs(got - want).max(-1) / unit
        assert gap.max() <= 16, gap.max()
        top = np.sort(-want, -1)
        confident = (top[:, k] - top[:, k - 1]) / unit > 32
        sets = [np.sort(np.argsort(-a, -1, kind="stable")[:, :k], -1) for a in (got, want)]
        same = (sets[0] == sets[1]).all(-1)
        assert same[confident].all()
        routes_agree &= bool(same.all())
    scale = ULP * np.abs(ref).max()
    if routes_agree and cfg.n_layers == 2:
        assert np.abs(logits - ref).max() <= 4 * scale
    assert np.abs(logits - ref32).max() <= np.abs(ref - ref32).max() + scale


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_prefill(arch):
    """At capacity 16, the reference's own setting (tests/test_models_smoke.py:64), so
    that no slot is dropped at prefill or decode."""
    check_decode_matches_prefill(f32(arch, capacity_factor=16.0))


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_specs_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    got = build_model(cfg, "cpu").cache_specs(3, 40)
    want = jax_build_model(jax_get_config(arch, smoke=True)).cache_specs(3, 40)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for kind in g:
            for name, (shape, dtype) in g[kind].items():
                spec = w[kind][name].value
                assert shape == spec.shape and str(dtype)[6:] == str(spec.dtype), (kind, name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_to_numpy_round_trips(arch):
    """The port's parameter tree is the reference's (jamba's ``blocks`` a tuple of 8
    position trees); float32 masters stay float32 through the round trip."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    tree = model.to_numpy()
    jtree = jax_build_model(jax_get_config(arch, smoke=True)).init_values(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, tree) == jax.tree.map(lambda a: a.shape, jtree)
    assert len(tree["blocks"]) == (8 if cfg.family == "hybrid" else 1)
    again = Model.from_numpy(cfg, tree, "cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for block in model.blocks:
        if block.kind == "ssm":
            for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm"):
                assert getattr(block.mixer, name).dtype == torch.float32, name
            assert block.mixer.w_in.dtype == block.mixer.w_out.dtype == torch.bfloat16
        if block.ffn_kind == "moe":
            assert block.ffn.w_up.dtype == block.ffn.router.dtype == torch.bfloat16


def test_init_follows_the_reference_scheme():
    """init_moe: dense_init with fan_in d for the router and E * d (E * ff for w_down)
    for the expert stacks (in_axis=1); init_ssd: dense_init for w_in, w_out and conv_w,
    zero conv bias, unit D and norm, A in [1, 16], softplus(dt_bias) in [1e-3, 1e-1]."""
    cfg = get_config("jamba-v0.1-52b", smoke=True).replace(d_model=128, moe_d_ff=256)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    ssm, mlp = model.blocks[1].mixer, model.blocks[1].ffn
    E = cfg.n_experts
    assert mlp.router.float().std().item() == pytest.approx(128**-0.5, rel=0.05)
    assert mlp.w_up.float().std().item() == pytest.approx((E * 128) ** -0.5, rel=0.05)
    assert mlp.w_down.float().std().item() == pytest.approx((E * 256) ** -0.5, rel=0.05)
    assert ssm.w_in.float().std().item() == pytest.approx(128**-0.5, rel=0.05)
    assert ssm.w_out.float().std().item() == pytest.approx(256**-0.5, rel=0.05)
    assert ssm.conv_w.std().item() == pytest.approx(cfg.conv_width**-0.5, rel=0.05)
    assert not ssm.conv_b.any() and (ssm.D == 1).all() and (ssm.norm == 1).all()
    a = ssm.A_log.exp()
    assert ((a >= 1) & (a <= 16)).all()
    dt = torch.nn.functional.softplus(ssm.dt_bias)
    assert ((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all()
    again = build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    assert torch.equal(again.blocks[1].mixer.A_log, ssm.A_log)


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_on_cpu(arch):
    r = serve.generate(arch, batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    assert r.tokens.shape == (2, 4) and r.tokens.dtype == np.int64
    assert (0 <= r.tokens).all() and (r.tokens < 512).all()
    again = serve.generate(arch, batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    np.testing.assert_array_equal(again.tokens, r.tokens)
