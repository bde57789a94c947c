"""Public entry for grouped-query attention (counterpart of the JAX package's
``kernels/attention/ops.py:gqa_attention``).

``impl="auto"`` launches the CUDA kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; nothing falls back from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ref import mha_ref


def gqa_attention(q, k, v, *, causal: bool = True, scale=None, impl: str = "auto"):
    """q: (B, S, H, hd); k/v: (B, S, K, hd) with H % K == 0. ``scale`` multiplies the
    scores (None: hd ** -0.5). impl: auto|cuda|ref."""
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "cuda":
        # the kernel reads KV head h // (H // K) itself
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if impl == "ref":
        H, K = q.shape[2], k.shape[2]
        if H % K != 0:
            raise ValueError(f"{H} query heads are not a multiple of {K} KV heads")
        if K != H:
            # each KV head serves H // K consecutive query heads (jnp.repeat, not tile)
            k = k.repeat_interleave(H // K, dim=2)
            v = v.repeat_interleave(H // K, dim=2)
        return mha_ref(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}; expected auto|cuda|ref")
