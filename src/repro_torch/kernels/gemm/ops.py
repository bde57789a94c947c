"""Public entry for the float32 matrix product.

``impl="auto"`` launches the CUDA kernel for a CUDA tensor and runs the plain
PyTorch version for any other (CPU, or meta under the analytic count); nothing
falls back from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.gemm.gemm import gemm_cuda
from repro_torch.kernels.gemm.ref import gemm_ref


def gemm(a, b, *, a_split=None, b_split=None, impl: str = "auto"):
    """a (m, k) @ b (k, n) -> (m, n). impl: auto|cuda|ref.

    ``a_split``, ``b_split``: ``split_rows(a)`` and ``split_cols(b)``, made once for an
    operand used many times; the kernel's form of it, which the plain version does not
    read."""
    if impl == "auto":
        impl = "cuda" if a.is_cuda else "ref"
    if impl == "cuda":
        return gemm_cuda(a, b, a_split, b_split)
    if impl == "ref":
        return gemm_ref(a, b)
    raise ValueError(f"unknown gemm impl {impl!r}; expected auto|cuda|ref")
