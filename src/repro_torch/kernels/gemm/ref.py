"""Plain PyTorch version of the float32 matrix product (MSET2's W = Ginv K and X_hat = W^T D).

The CPU path and the yardstick the CUDA kernel is held against on the card.
"""

from __future__ import annotations


def gemm_ref(a, b):
    """a (m, k) @ b (k, n) -> (m, n), in the inputs' dtype."""
    return a @ b
