"""Hand-written CUDA kernel for the float32 matrix product a @ b on Hopper (K4).

Replaces no Pallas kernel: MSET2's two products in ``estimate``, W = Ginv K and
X_hat = W^T D, which cuBLAS takes on the CUDA cores' FMA units in float32 (TF32 off).
The kernel source is ``csrc/gemm.cu``, built with nvcc for sm_90a and bound through
ctypes.

What bounds it: 2*m*n*k operations against (m + n)*k input and m*n output
elements; at MSET2's shapes (k = 8,192 memory vectors) the operations. It runs on
the TF32 tensor cores in three products (a and b split into TF32 hi + lo:
lo.hi + hi.lo + hi.hi), each 32-deep K tile promoted into a float32 accumulator,
which keeps float32's accuracy where one TF32 product would not. Two pre-passes
write the split into padded float32 scratch, which this wrapper allocates, K-major
(wgmma reads both operands so): a's rows as they are, or a transposed where a is the
transpose of a contiguous matrix (W^T), and b transposed. The product kernel computes
out = x . y^T over those planes. A caller that multiplies by the same operand many
times splits it once (``split_rows`` for a, ``split_cols`` for b) and passes the planes.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm.cu"
K_TILE = 32  # the kernel's K tile in floats: the split scratch's rows are padded to it

# Launches of the CUDA kernel (a call: the splits not given, and the product) since the
# count was last set to 0.
launches = 0
_lib = None
_ops = None  # the Library that registers the operators (kept alive) and the three of them
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
    ``::gemm_split_rows``, ``::gemm_split_cols``), registered at first use. The profiler links a
    kernel to the innermost operator that launched it, never to a ``record_function``
    range alone, so these make K4's device time visible under the spans around a call."""
    global _ops
    with _ops_lock:
        if _ops is None:
            lib = torch.library.Library("repro_torch", "FRAGMENT")
            lib.define(
                "gemm_tf32x3(Tensor a, Tensor b, Tensor? a_split, Tensor? b_split) -> Tensor"
            )
            lib.define("gemm_split_rows(Tensor a) -> Tensor")
            lib.define("gemm_split_cols(Tensor b) -> Tensor")
            lib.impl("gemm_tf32x3", _gemm, "CUDA")
            lib.impl("gemm_split_rows", lambda a: _split(a, *a.shape, transposed=False), "CUDA")
            lib.impl("gemm_split_cols", lambda b: _split(b, b.shape[1], b.shape[0], True), "CUDA")
            ops = torch.ops.repro_torch
            _ops = (
                lib,
                ops.gemm_tf32x3.default,
                ops.gemm_split_rows.default,
                ops.gemm_split_cols.default,
            )
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


def _gemm(a, b, a_split, b_split):
    """The operator's body: a @ b from a's and b's planes, each split here unless given;
    a is contiguous or the transpose of a contiguous matrix."""
    global launches
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if a_split is None:
        a_split = _split(a, m, k, False) if a.is_contiguous() else _split(a.T, m, k, True)
    if b_split is None:
        b_split = _split(b, n, k, transposed=True)
    err = _kernels().gemm_tf32x3_launch(
        a_split.data_ptr(), b_split.data_ptr(), out.data_ptr(), m, n, _k_pad(k), *_where(a)
    )
    _check(err, "gemm product")
    launches += 1
    return out


def _operand(name, t):
    _build.refuse_dtensors(name, t)
    if not (t.dtype == torch.float32 and t.dim() == 2 and t.is_contiguous() and t.is_cuda):
        raise ValueError(
            f"{name} takes a contiguous 2-D float32 CUDA tensor, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t


def split_rows(a):
    """a (m, k), contiguous float32 on a CUDA device -> its TF32 hi and lo planes
    (2, m, k_pad), the form in which ``gemm_cuda`` reads a: a caller that multiplies by
    the same a many times may split it once and pass the planes as ``a_split``."""
    return _operators()[1](_operand("split_rows", a))


def split_cols(b):
    """b (k, n), contiguous float32 on a CUDA device -> the TF32 hi and lo planes of its
    columns (2, n, k_pad), the form in which ``gemm_cuda`` reads b: for ``b_split``."""
    return _operators()[2](_operand("split_cols", b))


def gemm_cuda(a, b, a_split=None, b_split=None):
    """a (m, k) @ b (k, n): float32 CUDA tensors on one device -> (m, n) f32. b is
    contiguous; a is contiguous or the transpose of a contiguous matrix (``W.T``).

    ``a_split``, if given, is ``split_rows(a)`` (or ``split_cols(W)`` for a = W.T), and
    ``b_split`` is ``split_cols(b)``, made earlier."""
    _build.refuse_dtensors("gemm_cuda", a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"gemm_cuda takes float32, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a (m, k) and b (k, n), got {tuple(a.shape)}, {tuple(b.shape)}")
    if not ((a.is_contiguous() or a.T.is_contiguous()) and b.is_contiguous()):
        raise ValueError("gemm_cuda needs b contiguous, and a or its transpose contiguous")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(
            f"gemm_cuda needs a and b on one CUDA device, got {a.device} and {b.device}"
        )
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, _k_pad(k)) >= 2**31:
        raise ValueError(f"dimensions must fit in int32, got m={m}, n={n}, k={k}")
    for name, planes, rows in (("a_split", a_split, m), ("b_split", b_split, n)):
        if planes is not None and not (
            planes.shape == (2, rows, _k_pad(k))
            and planes.dtype == torch.float32
            and planes.is_contiguous()
            and planes.device == a.device
        ):
            raise ValueError(
                f"{name} is not the split of a {tuple(a.shape)} @ b {tuple(b.shape)}'s operand"
            )
    return _operators()[0](a, b, a_split, b_split)
