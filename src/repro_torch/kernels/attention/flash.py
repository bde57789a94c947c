"""Hand-written CUDA kernel for causal (or full) flash attention on Hopper.

Replaces ``repro/kernels/attention/flash.py:63 flash_attention`` (the Pallas TPU
kernel). The kernel source is ``csrc/flash.cu``, built with nvcc for sm_90a and
bound through ctypes.

What bounds it: 4·B·H·hd·S²/2 operations when causal against the bytes of q, k, v
and o, so at serving shapes (S in the thousands, hd = 128) it is bound by
operations. This first kernel computes in IEEE float32 FMA on the CUDA cores (the
float32 bar of 2e-5 rules out TF32): one block per 64 query rows of one head, a
loop over 64-key tiles with the running max, denominator and accumulator in
registers, the loop stopping at the diagonal when causal, ragged S masked in the
kernel, and KV head h // (H // K) read in place for GQA (no repeated copy).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0
_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load(SOURCE).flash_attention_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """q: (B, S, H, hd); k/v: (B, S, K, hd) with H % K == 0, CUDA tensors, all float32
    or all bfloat16, each with a contiguous last dim. Returns (B, S, H, hd) in q's dtype.
    """
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention_cuda needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_cuda takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, S, H, hd), k and v (B, S, K, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, hd = q.shape
    K = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or H % K != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (H % K == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_cuda needs a contiguous head dim in q, k and v")
    if B * H > 65535 or S >= 2**31:
        raise ValueError(f"B * H = {B * H} must be <= 65535 and S < 2**31")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0 or H == 0:
        return out
    err = _kernel()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        B,
        S,
        H,
        K,
        hd,
        *q.stride()[:3],
        *k.stride()[:3],
        *v.stride()[:3],
        *out.stride()[:3],
        _DTYPE_CODES[q.dtype],
        int(causal),
        hd**-0.5,
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA error {err}")
    launches += 1
    return out
