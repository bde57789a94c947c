"""Hand-written CUDA kernel for the float32 matrix product a @ b on Hopper (K4).

Replaces no Pallas kernel: MSET2's W = Ginv K, which cuBLAS takes on the CUDA cores'
FMA units in float32 (TF32 off). The kernel source is ``csrc/gemm.cu``, built with
nvcc for sm_90a and bound through ctypes.

What bounds it: 2*m*n*k operations against (m + n)*k input and m*n output
elements; at MSET2's shapes (k = 8,192 memory vectors) the operations. It runs on
the TF32 tensor cores in three products (a and b split into TF32 hi + lo:
lo.hi + hi.lo + hi.hi), each 32-deep K tile promoted into a float32 accumulator,
which keeps float32's accuracy where one TF32 product would not. Two pre-passes
write the split into padded float32 scratch, which this wrapper allocates: a's rows
as they are (K-major already), b transposed (wgmma reads both operands K-major). The
product kernel computes out = x . y^T over those planes, so an operand that is
K-major already needs no transposing pass.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm.cu"
K_TILE = 32  # the kernel's K tile in floats: the split scratch's rows are padded to it

# Launches of the CUDA kernel (a call: two splits and the product) since the count was
# last set to 0.
launches = 0
_lib = None
_ops = None  # the Library that registers the operators (kept alive) and the two of them
_ops_lock = threading.Lock()  # a second definition would raise


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        # src, dst, rows, k, k_pad, transposed, device, stream
        lib.gemm_split_launch.argtypes = [p, p, i, i, i, i, i, p]
        # x_split, y_split, out, m, n, k_pad, device, stream
        lib.gemm_tf32x3_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.gemm_split_launch.restype = lib.gemm_tf32x3_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _operators():
    """The launches as PyTorch operators (``repro_torch::gemm_tf32x3``,
    ``repro_torch::gemm_split_rows``), registered at first use. The profiler links a
    kernel to the innermost operator that launched it, never to a ``record_function``
    range alone, so these make K4's device time visible under the spans around a call."""
    global _ops
    with _ops_lock:
        if _ops is None:
            lib = torch.library.Library("repro_torch", "FRAGMENT")
            lib.define("gemm_tf32x3(Tensor a, Tensor b, Tensor? a_split) -> Tensor")
            lib.define("gemm_split_rows(Tensor a) -> Tensor")
            lib.impl("gemm_tf32x3", _gemm, "CUDA")
            lib.impl("gemm_split_rows", lambda a: _split(a, *a.shape, transposed=False), "CUDA")
            ops = torch.ops.repro_torch
            _ops = (lib, ops.gemm_tf32x3.default, ops.gemm_split_rows.default)
    return _ops[1:]


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _k_pad(k):
    return max(K_TILE, -(-k // K_TILE) * K_TILE)  # whole K tiles, at least one


def _where(t):
    device = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return device, torch.cuda.current_stream(t.device).cuda_stream


def _split(src, rows, k, transposed):
    """src's TF32 hi and lo planes (2, rows, k_pad): src is (rows, k), or with
    ``transposed`` (k, rows), whose transpose is split."""
    planes = torch.empty((2, rows, _k_pad(k)), dtype=torch.float32, device=src.device)
    if rows:
        err = _kernels().gemm_split_launch(
            src.data_ptr(), planes.data_ptr(), rows, k, _k_pad(k), int(transposed), *_where(src)
        )
        _check(err, "gemm split")
    return planes


def _gemm(a, b, a_split):
    """The operator's body: a @ b from a's planes (split here unless given) and b's."""
    global launches
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if a_split is None:
        a_split = _split(a, m, k, transposed=False)
    b_split = _split(b, n, k, transposed=True)
    err = _kernels().gemm_tf32x3_launch(
        a_split.data_ptr(), b_split.data_ptr(), out.data_ptr(), m, n, _k_pad(k), *_where(a)
    )
    _check(err, "gemm product")
    launches += 1
    return out


def split_rows(a):
    """a (m, k), contiguous float32 on a CUDA device -> its TF32 hi and lo planes
    (2, m, k_pad), the form in which ``gemm_cuda`` reads a: a caller that multiplies by
    the same a many times may split it once and pass the planes as ``a_split``."""
    _build.refuse_dtensors("split_rows", a)
    if not (a.dtype == torch.float32 and a.dim() == 2 and a.is_contiguous() and a.is_cuda):
        raise ValueError(
            "split_rows takes a contiguous 2-D float32 CUDA tensor, "
            f"got {a.dtype} {tuple(a.shape)} on {a.device}"
        )
    return _operators()[1](a)


def gemm_cuda(a, b, a_split=None):
    """a (m, k) @ b (k, n): contiguous float32 CUDA tensors on one device -> (m, n) f32.

    ``a_split``, if given, is ``split_rows(a)``, made earlier."""
    _build.refuse_dtensors("gemm_cuda", a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"gemm_cuda takes float32, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a (m, k) and b (k, n), got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm_cuda needs contiguous a and b")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(
            f"gemm_cuda needs a and b on one CUDA device, got {a.device} and {b.device}"
        )
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, _k_pad(k)) >= 2**31:
        raise ValueError(f"dimensions must fit in int32, got m={m}, n={n}, k={k}")
    if a_split is not None and not (
        a_split.shape == (2, m, _k_pad(k))
        and a_split.dtype == torch.float32
        and a_split.is_contiguous()
        and a_split.device == a.device
    ):
        raise ValueError(f"a_split is not split_rows(a) for a of shape {tuple(a.shape)}")
    return _operators()[0](a, b, a_split)
