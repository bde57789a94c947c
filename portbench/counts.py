"""Operations, bytes and peaks: the arithmetic that turns device times into shares.

Every count is worked out here from a cell's own shapes; nothing is read from the
program. Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assume the card's full 700 W power limit.
"""

from __future__ import annotations

PEAK_TF32_FLOPS = 495e12  # TF32 tensor cores; no float32-faithful product runs faster
PEAK_HBM_BYTES = 3.35e12  # HBM3, bytes a second
F32_BYTES = 4
SPRT_BYTES_PER_ELEMENT = 13  # a float32 residual read; an alarm byte and two float32 LLRs written


def k1_flops(m: int, b: int, n: int) -> float:
    """The similarity operator over (m, n) x (b, n): one multiply-add a pair a signal."""
    return 2.0 * m * b * n


def k1_bytes(m: int, b: int, n: int) -> float:
    """D and X read once, the (m, b) similarity written once, all float32."""
    return float(F32_BYTES * ((m + b) * n + m * b))


def k1_seconds_at_roofline(m: int, b: int, n: int) -> float:
    return max(k1_flops(m, b, n) / PEAK_TF32_FLOPS, k1_bytes(m, b, n) / PEAK_HBM_BYTES)


def k3_seconds_at_roofline(t: int, n: int) -> float:
    """The SPRT recursion over (t, n) residuals moves 13 bytes an element."""
    return SPRT_BYTES_PER_ELEMENT * t * n / PEAK_HBM_BYTES


def surveil_flops(m: int, b: int, n: int) -> float:
    """One surveillance batch of b observations: K = D (x) X (2mbn), W = Ginv K (2m^2 b)
    and x_hat = W^T D (2bmn)."""
    return 2.0 * m * b * n + 2.0 * m * m * b + 2.0 * b * m * n
