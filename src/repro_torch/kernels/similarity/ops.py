"""Public entry for the similarity operator.

``impl="auto"`` launches the CUDA kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; nothing falls back from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.similarity.ref import similarity_ref
from repro_torch.kernels.similarity.similarity import similarity_cuda


def similarity(x, y, *, gamma: float = 1.0, kind: str = "inverse_distance", impl: str = "auto"):
    """Pairwise similarity S = h(dist(x, y)). impl: auto|cuda|ref."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "cuda":
        return similarity_cuda(x, y, gamma, kind)
    if impl == "ref":
        return similarity_ref(x, y, gamma, kind)
    raise ValueError(f"unknown similarity impl {impl!r}; expected auto|cuda|ref")
