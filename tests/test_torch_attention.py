"""The port's attention (plain version and ``gqa_attention``) against the JAX
package's ``mha_ref``, ``flash_attention`` (Pallas, interpret mode) and
``gqa_attention``, on the CPU. The CUDA kernel itself runs only on a card: its tests
are in tests/test_torch_gpu.py and carry the ``gpu`` marker.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import numpy as np

from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.kernels.attention import gqa_attention as jax_gqa_attention
from repro.kernels.attention import mha_ref as jax_mha_ref
from repro_torch.kernels import gqa_attention, mha_ref

# the wrapper module, which keeps the launch count
flash_module = importlib.import_module("repro_torch.kernels.attention.flash")

# tests/test_kernels.py's shapes (B, S, H, hd) and bars: 2e-5 in float32; 5e-2 in
# bfloat16 (both sides get the same bf16 inputs; the reference's outputs are bf16 too)
SHAPES = [(2, 128, 2, 64), (1, 256, 4, 32), (2, 200, 2, 64), (1, 64, 1, 128)]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _qkv(B, S, H, hd, K=None, seed=0):
    rng = np.random.default_rng(seed)
    K = K or H
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, pt


@pytest.mark.parametrize("B,S,H,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference(B, S, H, hd, causal, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, H, hd), dtype)
    ref = np.asarray(jax_mha_ref(jq, jk, jv, causal=causal), np.float32)
    tol = TOL[dtype]
    for out in (mha_ref(q, k, v, causal=causal), gqa_attention(q, k, v, causal=causal)):
        assert out.dtype == q.dtype and out.shape == q.shape
        np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,hd", [(2, 200, 2, 64), (1, 128, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_kernel(B, S, H, hd, causal):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, H, hd, seed=1), "float32")
    ref = jax_flash_attention(jq, jk, jv, causal=causal, bq=64, bkv=64, interpret=True)
    out = gqa_attention(q, k, v, causal=causal, impl="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@settings(max_examples=8, deadline=None)
@given(S=st.integers(16, 160), hd=st.sampled_from([16, 32, 64]))
def test_plain_version_hypothesis(S, hd):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, S, 2, hd, seed=S), "float32")
    ref = jax_mha_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(mha_ref(q, k, v).numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_reference_wrapper(causal):
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 64, 8, 32, K=2, seed=2), "float32")
    ref = jax_gqa_attention(jq, jk, jv, causal=causal, impl="interpret")
    out = gqa_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    # each KV head serves H // K consecutive query heads ([0,0,0,0,1,1,1,1]), not a tile
    tiled = mha_ref(q, k.repeat(1, 1, 4, 1), v.repeat(1, 1, 4, 1), causal=causal)
    assert not torch.allclose(out, tiled, atol=1e-3)


def test_chunks_equal_one_chunk(monkeypatch):
    ref_module = importlib.import_module("repro_torch.kernels.attention.ref")
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 200, 2, 32, seed=3))
    for causal in (False, True):
        whole = mha_ref(q, k, v, causal=causal)  # one chunk: S < Q_CHUNK
        monkeypatch.setattr(ref_module, "Q_CHUNK", 64)  # 64 + 64 + 64 + 8 rows
        chunked = mha_ref(q, k, v, causal=causal)
        monkeypatch.undo()
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6, rtol=1e-6)
    # the causal tail rows alone, at their absolute positions, as chip_smoke.py checks
    # the 32k shape
    monkeypatch.setattr(ref_module, "Q_CHUNK", 16)
    tail = mha_ref(q[:, -50:], k, v, q_offset=150)
    np.testing.assert_allclose(tail.numpy(), whole[:, -50:].numpy(), atol=1e-6, rtol=1e-6)


def test_cuda_impl_on_a_cpu_tensor_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 16))
    before = flash_module.launches
    with pytest.raises(ValueError, match="CUDA device"):
        gqa_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        gqa_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="multiple"):
        gqa_attention(q, k[:, :, :1].expand(1, 16, 3, 16), v, impl="ref")
    assert flash_module.launches == before


# ---- the bf16 kernel's arithmetic: why P . V takes two bf16 products ---------------


def _emulate_bf16_kernel(q, k, v, split_p):
    """The bf16 CUDA kernel's arithmetic on the CPU: causal online softmax over tiles of
    64 keys with float32 m, l and acc, scores from bf16 q and k, and P . V with P in bf16,
    either as hi = bf16(p) plus lo = bf16(p - hi) (two products, as the kernel does) or
    rounded once (``split_p=False``). Each product of bf16 values is exact in float32,
    as on the tensor cores; only the order of the float32 sums differs."""
    B, S, H, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, hd)
    rows = torch.arange(S)
    for kv0 in range(0, S, 64):
        kt, vt = kf[:, kv0 : kv0 + 64], vf[:, kv0 : kv0 + 64]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * hd**-0.5
        cols = kv0 + torch.arange(kt.shape[1])
        s = s.masked_fill(cols[None, :] > rows[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        hi = p.bfloat16().float()
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vt)
        if split_p:
            lo = (p - hi).bfloat16().float()
            pv = pv + torch.einsum("bhqk,bkhd->bhqd", lo, vt)
        acc = alpha[..., None] * acc + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize(
    "S,hd,q_scale", [(512, 128, 1.0), (300, 64, 1.0), (512, 128, 4.0), (1024, 16, 1.0)]
)
def test_split_p_holds_the_bf16_bar_where_one_rounding_does_not(S, hd, q_scale):
    rng = np.random.default_rng(S + hd)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((1, S, 2, hd)).astype(np.float32))
        for _ in range(3)
    )
    q, k, v = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
    ref = mha_ref(q, k, v).float()
    # the card's bf16 bar (chip_smoke.py flash_bar, tests/test_torch_gpu.py): one bf16
    # ulp of the plain version's output
    bar = 1e-5 + 2.0**-7 * ref.abs()
    over = {
        split: int(((_emulate_bf16_kernel(q, k, v, split).float() - ref).abs() > bar).sum())
        for split in (True, False)
    }
    assert over[True] == 0, over
    assert over[False] > 0, over


def test_tma_layout_rule():
    check_tma_layout = flash_module.check_tma_layout
    base = torch.zeros(2 * 64 * 4 * 32 + 8, dtype=torch.bfloat16)
    check_tma_layout("q", base[: 2 * 64 * 4 * 32].view(2, 64, 4, 32))
    # heads-major views (the KV cache's layout) are aligned
    check_tma_layout("v", torch.zeros(2, 4, 64, 32, dtype=torch.bfloat16).transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_tma_layout("q", base[1 : 1 + 2 * 64 * 4 * 32].view(2, 64, 4, 32))
    with pytest.raises(ValueError, match="multiples of 8"):
        check_tma_layout("k", torch.zeros(2, 64, 4, 36, dtype=torch.bfloat16)[..., :32])
