"""Public entry for the SPRT recursion.

``impl="auto"`` launches the CUDA kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; nothing falls back from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.sprt.ref import sprt_ref
from repro_torch.kernels.sprt.sprt import sprt_cuda


def sprt_scan(
    residuals, sigma, mu=None, *, m_shift, upper, lower, impl: str = "auto", reruns=None
):
    """Two-sided SPRT over (T, n) residuals -> (alarms, llr_pos, llr_neg). impl: auto|cuda|ref.

    ``reruns`` is ``sprt_cuda``'s counter of pass 2's re-run steps; the plain version
    re-runs nothing and leaves it as it is."""
    if impl == "auto":
        impl = "cuda" if residuals.is_cuda else "ref"
    if impl == "cuda":
        return sprt_cuda(residuals, sigma, mu, m_shift, upper, lower, reruns=reruns)
    if impl == "ref":
        return sprt_ref(residuals, sigma, mu, m_shift, upper, lower)
    raise ValueError(f"unknown sprt impl {impl!r}; expected auto|cuda|ref")
