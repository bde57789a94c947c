"""The port's 3xTF32 arithmetic emulated with numpy: K1's (similarity.cu) and K4's
(gemm.cu) products, which share it, are held to float32 with these on the CPU; and the
float32 product that cuBLAS's SIMT kernel computes, for a yardstick."""

import numpy as np


def tf32(a):
    """float32 -> TF32 (10 fraction bits), to nearest with ties away from zero, by bit
    arithmetic on the int32 view: the kernel's cvt.rna.tf32.f32 with the 13 low bits cleared."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    bits = (a.view(np.int32) + np.int32(0x1000)) & np.int32(-0x2000)
    return np.where(np.isfinite(a), bits.view(np.float32), a)


def split(a):
    """a = hi + lo to about 2^-22 relative; a - hi is exact in float32."""
    hi = tf32(a)
    return hi, tf32(a - hi)


def truncating_product(x, y, depth=8, tile=None):
    """x . y^T from the three products through a float32 accumulator that rounds toward
    zero after each `depth`-deep step of each product (lo.hi, hi.lo, then hi.hi, as the
    kernels issue them): a pessimistic model of the tensor cores' adder. With `tile`, each
    `tile`-deep slice is summed from zero that way and then added into a float32 sum
    rounded to nearest: the kernels' promotion of each 32-deep K tile."""
    (xh, xl), (yh, yl) = split(x), split(y)
    total = np.zeros((x.shape[0], y.shape[0]), np.float32)
    part = np.zeros_like(total)
    for k in range(0, x.shape[1], depth):
        if tile and k % tile == 0:
            total, part = total + part, np.zeros_like(part)
        for a, c in ((xl, yh), (xh, yl), (xh, yh)):
            exact = part.astype(np.float64) + (
                a[:, k : k + depth].astype(np.float64) @ c[:, k : k + depth].T.astype(np.float64)
            )
            part = exact.astype(np.float32)
            away = np.abs(part.astype(np.float64)) > np.abs(exact)
            part[away] = np.nextafter(part[away], np.float32(0))
    return total + part


def fma_chain(x, y):
    """x . y^T in float32 as one fused multiply-add chain an output along the contraction,
    each step rounded to nearest once: the arithmetic of cuBLAS's SIMT sgemm, whose threads
    each accumulate their outputs in registers over the whole of k."""
    x64, y64 = np.asarray(x, np.float64), np.asarray(y, np.float64)
    acc = np.zeros((x.shape[0], y.shape[0]), np.float32)
    for k in range(x.shape[1]):
        acc = (acc + np.multiply.outer(x64[:, k], y64[:, k])).astype(np.float32)
    return acc
