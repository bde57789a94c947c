"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``models/moe.py`` on the CPU: routing (ties included), grouping (drops included),
the gather path, and the combine's order in bf16.

Inputs are numpy draws from a seed; f32 results are held at tests/test_moe.py's own
bar (atol 1e-5, rtol 1e-4), indices and groupings bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.distributed import make_rules
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import moe
from test_moe import _dense_reference

RULES = make_rules(None)
ATOL, RTOL = 1e-5, 1e-4


def _cfgs(E=8, k=2, d=16, ff=32, cap=1.25, mlp_type="swiglu"):
    kw = dict(
        n_experts=E,
        n_experts_per_tok=k,
        moe_d_ff=ff,
        d_model=d,
        capacity_factor=cap,
        mlp_type=mlp_type,
        dtype="float32",
    )
    return (
        get_config("olmoe-1b-7b", smoke=True).replace(**kw),
        jax_get_config("olmoe-1b-7b", smoke=True).replace(**kw),
    )


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": rng.standard_normal((d, E)) / np.sqrt(d),
        "w_up": rng.standard_normal((E, d, ff)) / np.sqrt(d),
        "w_down": rng.standard_normal((E, ff, d)) / np.sqrt(ff),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = rng.standard_normal((E, d, ff)) / np.sqrt(d)
    return {n: a.astype(np.float32) for n, a in p.items()}


def _torch(p):
    return {n: torch.from_numpy(a) for n, a in p.items()}


# ------------------------------ routing --------------------------------------


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("E, k", [(8, 2), (64, 8), (40, 8)])
def test_route_matches_reference(E, k, ties):
    """With ties, logits are small integers: many equal probabilities straddle the
    k-th place, and the lower expert index must come first, as in ``lax.top_k``."""
    port, ref = _cfgs(E=E, k=k)
    rng = np.random.default_rng(E * 10 + ties)
    if ties:
        logits = rng.integers(0, 3, (96, E)).astype(np.float32)
    else:
        logits = rng.standard_normal((96, E)).astype(np.float32) * 2
    ji, jw, jaux = jax_moe._route(ref, jnp.asarray(logits))
    ti, tw, taux = moe._route(port, torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=RTOL)


def test_route_ties_in_bf16_logits():
    """bf16 router logits at 64 experts: ties between the 8th and the 9th expert, as
    the working dtype makes them."""
    port, ref = _cfgs(E=64, k=8)
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32) / 4).bfloat16()
    probs = np.sort(logits.float().numpy(), -1)[:, ::-1]
    assert (probs[:, 7] == probs[:, 8]).any()  # the case this test is for
    ji, jw, _ = jax_moe._route(ref, jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16))
    ti, tw, _ = moe._route(port, logits)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the weights are renormalised in float32, summed in either package's order, then
    # rounded to bf16: within one bf16 ulp
    np.testing.assert_allclose(tw.float().numpy(), np.asarray(jw, np.float32), rtol=2**-7)


# ------------------------------ grouping -------------------------------------

GROUPS = [
    # (T, E, k, C): ample capacity, tight capacity, tests/test_moe.py:55's 0.25, decode
    (32, 8, 2, 32),
    (32, 8, 2, 10),
    (32, 8, 2, 2),
    (4, 64, 8, 1),
    (61, 40, 8, 15),
]


@pytest.mark.parametrize("T, E, k, C", GROUPS)
def test_group_matches_reference(T, E, k, C):
    rng = np.random.default_rng(T + E + C)
    token_e = np.stack([rng.permutation(E)[:k] for _ in range(T)]).reshape(-1)
    token_w = rng.random(T * k).astype(np.float32)
    ji, jw = jax_moe._group(jnp.asarray(token_e, jnp.int32), jnp.asarray(token_w), T, E, C)
    ti, tw, _ = moe._group(torch.from_numpy(token_e), torch.from_numpy(token_w), T, E, C)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("cap", [1, 2, 4])
def test_group_respects_capacity(cap):
    """tests/test_property.py:114's case: every token to expert 0, the rest dropped."""
    T, E, k = 32, 4, 2
    token_e = np.zeros(T * k, np.int64)
    token_w = np.ones(T * k, np.float32)
    ji, jw = jax_moe._group(jnp.asarray(token_e, jnp.int32), jnp.asarray(token_w), T, E, cap)
    ti, tw, slot = moe._group(torch.from_numpy(token_e), torch.from_numpy(token_w), T, E, cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (ti[0] < T).sum() == cap and (slot == E * cap).sum() == T * k - cap


def test_group_conserves_tokens():
    """tests/test_property.py:97's case: with capacity T nothing is dropped, and every
    (token, slot) appears exactly once."""
    T, E, k = 48, 8, 2
    rng = np.random.default_rng(3)
    token_e = rng.integers(0, E, T * k)
    ti, tw, slot = moe._group(torch.from_numpy(token_e), torch.ones(T * k), T, E, T)
    assert (slot < E * T).all() and len(set(slot.tolist())) == T * k
    counts = np.bincount(ti.numpy().ravel(), minlength=T + 1)
    assert counts[:T].sum() == T * k and float(tw.sum()) == T * k


# ------------------------------ the gather path ------------------------------


@pytest.mark.parametrize("cap", [1.25, 0.25, 64.0])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_apply_moe_matches_reference(cap, mlp_type):
    port, ref = _cfgs(cap=cap, mlp_type=mlp_type)
    p = _params(port)
    x = np.random.default_rng(1).standard_normal((2, 16, port.d_model)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    jy, jaux = jax_moe._moe_gather(ref, jp, jnp.asarray(x), RULES)
    ty, taux = moe.apply_moe(port, _torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=RTOL)
    # the reference's apply_moe without a mesh is the same path
    jy2, _ = jax_moe.apply_moe(ref, jp, jnp.asarray(x), RULES)
    np.testing.assert_array_equal(np.asarray(jy2), np.asarray(jy))


def test_apply_moe_matches_dense_reference():
    """tests/test_moe.py's all-experts reference at capacity 64: nothing dropped."""
    port, ref = _cfgs(cap=64.0)
    p = _params(port, seed=5)
    x = np.random.default_rng(2).standard_normal((2, 16, port.d_model)).astype(np.float32)
    want = _dense_reference(ref, {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    got, aux = moe.apply_moe(port, _torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert float(aux) > 0


def test_apply_moe_drops_over_capacity():
    port, _ = _cfgs(cap=0.25)
    p = _params(port, seed=5)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 16, 16))).float()
    dropped, _ = moe.apply_moe(port, _torch(p), x)
    full, _ = moe.apply_moe(port.replace(capacity_factor=64.0), _torch(p), x)
    assert torch.isfinite(dropped).all() and not torch.allclose(dropped, full)


@pytest.mark.parametrize(
    "T, E, k, C", [(64, 8, 2, 20), (512, 64, 8, 80), (4, 64, 8, 1), (33, 8, 2, 3)]
)
def test_combine_order_matches_reference_bits(T, E, k, C):
    """bf16: each token's k rows summed in ascending expert id from zero gives the
    reference's ``.at[idx].add`` (moe.py:137) on the CPU bit for bit, drops included."""
    rng = np.random.default_rng(T)
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    w = rng.random(T * k).astype(np.float32)
    idx, _ = jax_moe._group(jnp.asarray(top_i.reshape(-1), jnp.int32), jnp.asarray(w), T, E, C)
    yg = (rng.standard_normal((E, C, 16)) * 3).astype(np.float32)

    def scatter_add(yg, idx):
        y = jnp.zeros((T + 1, 16), jnp.bfloat16).at[idx.reshape(-1)].add(yg.reshape(E * C, 16))
        return y[:T]

    want = jax.jit(scatter_add)(jnp.asarray(yg).astype(jnp.bfloat16), idx)
    _, _, slot = moe._group(torch.from_numpy(top_i.reshape(-1)), torch.from_numpy(w), T, E, C)
    rows = torch.cat([torch.from_numpy(yg).bfloat16().view(E * C, 16), torch.zeros(1, 16)])
    got = moe._combine(rows.bfloat16(), slot, torch.from_numpy(top_i), T)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_capacity_is_the_reference_expression():
    for T, E, k, cap in [(8192, 64, 8, 1.25), (4, 64, 8, 1.25), (30, 8, 2, 1.25), (7, 40, 8, 0.3)]:
        port, ref = _cfgs(E=E, k=k, cap=cap)
        want = min(max(1, int(np.ceil(T * k / E * cap))), T)
        assert moe.capacity(port, T) == want
    assert moe.capacity(get_config("olmoe-1b-7b"), 4 * 2048) == 1280
    assert moe.capacity(get_config("olmoe-1b-7b"), 4) == 1
