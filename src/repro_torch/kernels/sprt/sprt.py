"""Hand-written CUDA kernel for the two-sided SPRT recursion on Hopper (K3).

Replaces the ``lax.scan`` of ``repro/mset/sprt.py:sprt``, which is not a Pallas
kernel: this is the port's own kernel, since eager torch would otherwise walk time
in Python with four launches a step. The kernel source is ``csrc/sprt.cu``, built
with nvcc for sm_90a and bound through ctypes.

What bounds it: bytes. It reads the (T, n) f32 residuals once and writes the
(T, n) alarms and the (T, 2, n) LLRs once, doing a few operations an element. One
thread walks time for one signal with both sums in registers, loading residuals a
chunk of steps ahead of the recursion, and repeats the plain version's float32
operations in its order with no contraction, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sprt.cu"

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0
_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load(SOURCE).sprt_launch
        pointers, floats = [ctypes.c_void_p] * 5, [ctypes.c_float] * 5
        # r, mu, sigma, alarms, llr, T, n, m_pos, m_neg, half_m2, upper, lower, device, stream
        fn.argtypes = pointers + [ctypes.c_longlong, ctypes.c_int] + floats
        fn.argtypes += [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def sprt_cuda(residuals, sigma, mu, m_shift: float, upper: float, lower: float):
    """residuals (T, n), sigma and mu (n,) (mu may be None), CUDA tensors on one device
    -> (alarms (T, n) bool, llr_pos, llr_neg (T, n) f32 views of one (T, 2, n) array).

    Inputs of another float dtype are converted to float32, as the plain version
    converts them, and made contiguous; the kernel reads (T, n) row-major."""
    global launches
    vecs = [v for v in (sigma, mu) if v is not None]
    if not all(v.is_cuda and v.device == residuals.device for v in [residuals, *vecs]):
        devs = [str(v.device) for v in [residuals, *vecs]]
        raise ValueError(f"sprt_cuda needs its tensors on one CUDA device, got {devs}")
    if not all(v.is_floating_point() for v in [residuals, *vecs]):
        raise TypeError("sprt_cuda takes floating-point residuals, sigma and mu")
    if residuals.dim() != 2:
        raise ValueError(f"expected residuals (T, n), got {tuple(residuals.shape)}")
    T, n = residuals.shape
    if any(v.shape != (n,) for v in vecs):
        raise ValueError(f"sigma and mu must be ({n},), got {[tuple(v.shape) for v in vecs]}")
    if n >= 2**31:
        raise ValueError(f"n must fit in int32, got {n}")
    r = residuals.float().contiguous()
    sig = sigma.float().contiguous()
    mu32 = None if mu is None else mu.float().contiguous()
    alarms = torch.empty((T, n), dtype=torch.bool, device=r.device)
    llr = torch.empty((T, 2, n), dtype=torch.float32, device=r.device)
    if T == 0 or n == 0:
        return alarms, llr[:, 0], llr[:, 1]
    # ctypes rounds each Python float to float32 (c_float), as torch rounds a Python
    # scalar for a float32 op: M, -M and M^2/2 reach the kernel as the plain loop uses them
    M = float(m_shift)
    err = _kernel()(
        r.data_ptr(),
        None if mu32 is None else mu32.data_ptr(),
        sig.data_ptr(),
        alarms.data_ptr(),
        llr.data_ptr(),
        T,
        n,
        M,
        -M,
        0.5 * M * M,
        upper,
        lower,
        r.device.index if r.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sprt kernel launch failed with CUDA error {err}")
    launches += 1
    return alarms, llr[:, 0], llr[:, 1]
