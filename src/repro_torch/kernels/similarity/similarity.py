"""Hand-written CUDA kernel for the MSET2 pairwise-similarity operator on Hopper.

Replaces ``repro/kernels/similarity/similarity.py:similarity_pallas`` (the Pallas
TPU kernel). The kernel source is ``csrc/similarity.cu``, built with nvcc for
sm_90a and bound through ctypes.

What bounds it: 2*m*b*n operations against (m + b)*n input and m*b output
elements; at the MSET2 shapes (n = 1024) it is bound by operations. It runs on
the TF32 tensor cores in three products (x and y split into TF32 hi + lo:
hi.hi + hi.lo + lo.hi), which keeps float32 accuracy where one TF32 product
misses the 5e-6 bar. A pre-pass writes the split into padded float32 scratch,
which this wrapper allocates, with the rows' squared norms; the product kernel
reads it through TMA into wgmma and fuses the clamp and the kind's nonlinearity
into the store. bfloat16 inputs are TF32 values already and take one product.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.similarity.ref import KINDS

SOURCE = Path(__file__).resolve().parent / "csrc" / "similarity.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
K_TILE = 32  # the kernel's K tile in floats: the split scratch's rows are padded to it

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0
_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load(SOURCE).similarity_launch
        pointers, ints = [ctypes.c_void_p] * 7, [ctypes.c_int] * 6
        tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.argtypes = pointers + ints + tail  # ..., epi, same, device, stream
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def similarity_cuda(x, y, gamma: float = 1.0, kind: str = "inverse_distance"):
    """x: (m, n), y: (b, n) CUDA tensors, both float32 or both bfloat16 -> (m, b) f32."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"unknown similarity kind {kind!r}")
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ValueError(
            f"similarity_cuda needs x and y on one CUDA device, got {x.device} and {y.device}"
        )
    if x.dtype not in _DTYPE_CODES or y.dtype != x.dtype:
        raise TypeError(f"similarity_cuda takes float32 or bfloat16, got {x.dtype} and {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"expected x (m, n) and y (b, n), got {tuple(x.shape)}, {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("similarity_cuda needs contiguous x and y")
    (m, n), b = x.shape, y.shape[0]
    if max(m, b, n) >= 2**31:
        raise ValueError(f"dimensions must fit in int32, got m={m}, b={b}, n={n}")
    out = torch.empty((m, b), dtype=torch.float32, device=x.device)
    if m == 0 or b == 0:
        return out
    # contiguous tensors with one address, shape and dtype hold the same values
    same = y is x or (y.data_ptr() == x.data_ptr() and y.shape == x.shape)
    # hi and lo planes (bf16 values need no lo); rows padded to whole K tiles, at least one
    planes, n_pad = (2 if x.dtype == torch.float32 else 1), max(K_TILE, -(-n // K_TILE) * K_TILE)

    def scratch(rows):
        return (
            torch.empty((planes, rows, n_pad), dtype=torch.float32, device=x.device),
            torch.empty(rows, dtype=torch.float32, device=x.device),
        )

    xs, x2 = scratch(m)
    ys, y2 = (xs, x2) if same else scratch(b)
    epi = float(gamma) if kind == "inverse_distance" else 2.0 * gamma * gamma
    fn = _kernel()
    err = fn(
        x.data_ptr(),
        y.data_ptr(),
        xs.data_ptr(),
        ys.data_ptr(),
        x2.data_ptr(),
        y2.data_ptr(),
        out.data_ptr(),
        m,
        b,
        n,
        n_pad,
        _DTYPE_CODES[x.dtype],
        KINDS.index(kind),
        epi,
        int(same),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"similarity kernel launch failed with CUDA error {err}")
    launches += 1
    return out
