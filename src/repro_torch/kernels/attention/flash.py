"""Hand-written CUDA kernel for causal (or full) flash attention on Hopper.

Replaces ``repro/kernels/attention/flash.py:63 flash_attention`` (the Pallas TPU
kernel). The kernel source is ``csrc/flash.cu``, built with nvcc for sm_90a and
bound through ctypes.

What bounds it: 4·B·H·hd·S²/2 operations when causal against the bytes of q, k, v
and o, so at serving shapes (S in the thousands, hd = 128) it is bound by
operations. In both kernels, each 64 query rows of one head loop over 64-key
tiles with the running max, denominator and accumulator in registers, stop at the
diagonal when causal, mask ragged S in the kernel, and read KV head h // (H // K)
in place for GQA (no repeated copy). One C entry dispatches on dtype:

- bfloat16 (the serving path) runs on the tensor cores. A producer warpgroup's
  TMA loads fill a ring of two K and two V tiles, signalled by mbarriers; two
  consumer warpgroups (64 query rows each) compute S = Q·Kᵀ with ``wgmma`` from
  shared memory, the online softmax in their accumulator registers, and P·V with
  ``wgmma`` from registers. P is split into bf16 hi + lo and both are multiplied, so that P·V
  keeps the float32 P of the Pallas kernel: P rounded once to bf16 puts outputs
  more than one bf16 ulp from the plain version (tests/test_torch_attention.py).
  TMA needs q, k and v 16-byte aligned with (b, s, h) strides that are multiples
  of 8 elements; other bf16 inputs raise ``ValueError`` (nothing is copied).
- float32 keeps the IEEE float32 FMA kernel on the CUDA cores: the float32 bar of
  2e-5 rules out TF32.

The launch runs as the PyTorch operator ``repro_torch::flash_attention``, registered at
first use: the profiler links a kernel to the innermost operator that launched it,
never to a ``record_function`` range alone, so through it K2's device time shows under
the spans around a call (``lm.attention``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0
_launch_fn = None
_op = None  # (the Library that registers the operator, kept alive; the operator)
_op_lock = threading.Lock()  # a second definition would raise


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


def check_tma_layout(name, t):
    """Raise ValueError unless TMA can load bf16 ``t``: its data 16-byte aligned and
    its (b, s, h) strides multiples of 8 elements (16 bytes)."""
    if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:3]):
        raise ValueError(
            f"bfloat16 flash attention loads {name} with TMA, which needs its data 16-byte "
            f"aligned and its (b, s, h) strides multiples of 8 elements; got data_ptr % 16 = "
            f"{t.data_ptr() % 16} and strides {tuple(t.stride()[:3])}"
        )


def _operator():
    """``repro_torch::flash_attention``, registered at first use."""
    global _op
    with _op_lock:
        if _op is None:
            lib = torch.library.Library("repro_torch", "FRAGMENT")
            lib.define(
                "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, float scale) -> Tensor"
            )
            lib.impl("flash_attention", _launch, "CUDA")
            _op = (lib, torch.ops.repro_torch.flash_attention.default)
    return _op[1]


def _launch(q, k, v, causal, scale):
    """The operator's body: one launch of the kernel into a new output."""
    global launches
    B, S, H, hd = q.shape
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
        k.shape[2],
        hd,
        *q.stride()[:3],
        *k.stride()[:3],
        *v.stride()[:3],
        *out.stride()[:3],
        _DTYPE_CODES[q.dtype],
        int(causal),
        scale,
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale=None):
    """q: (B, S, H, hd); k/v: (B, S, K, hd) with H % K == 0, CUDA tensors, all float32
    or all bfloat16, each with a contiguous last dim (bfloat16: laid out for TMA, see
    ``check_tma_layout``). ``scale`` multiplies the scores (None: hd ** -0.5). Returns
    (B, S, H, hd) in q's dtype.

    The kernel has no backward, so it refuses inputs that need a gradient: its output
    would carry none to them (training runs ``models.layers._sdpa_heads``).
    """
    _build.refuse_dtensors("flash_attention_cuda", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention_cuda (K2) has no backward: its output would carry no gradient "
            "to q, k and v. Training attention runs models.layers._sdpa_heads, the "
            "reference's plain _sdpa; call K2 under torch.no_grad() or on detached inputs"
        )
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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, t)
    return _operator()(q, k, v, bool(causal), float(hd**-0.5 if scale is None else scale))
