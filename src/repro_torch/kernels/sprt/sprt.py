"""Hand-written CUDA kernel for the two-sided SPRT recursion on Hopper (K3).

Replaces the ``lax.scan`` of ``repro/mset/sprt.py:sprt``, which is not a Pallas
kernel: this is the port's own kernel, since eager torch would otherwise walk time
in Python with four launches a step. The kernel source is ``csrc/sprt.cu``, built
with nvcc for sm_90a and bound through ctypes.

What bounds it: bytes. It reads the (T, n) f32 residuals once and writes the
(T, n) alarms and the (T, 2, n) LLRs once, doing a few operations an element. The
recursion is sequential in time, so a call is a chunked, time-parallel scan of two
launches: pass 1 runs every chunk of L steps at once, one thread for each (chunk,
signal), each chunk after the first from a guessed start (``lower``); pass 2 takes
each signal's chunks in order and re-runs each from its true start only until it
meets pass 1's trajectory bit for bit (a clamp to ``lower`` or a restart makes the
state forget its start), one warp a signal with a lane a chunk. L is picked so that
the chunks times the signals fill the card; with one chunk the call is one launch,
one thread walking all of time for each signal. A signal whose trajectories never
meet (a NaN residual) is walked step by step from there on. Every float operation
repeats the plain version's in its order with no contraction, so the two agree bit
for bit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sprt.cu"

# Calls that launched the kernel since the count was last set to 0 (a call is two
# launches, pass 1 and pass 2, or one when it has a single chunk).
launches = 0
_launch_fn = None

# Pass 1 keeps its pace down to about 256 (chunk, signal) threads an SM; pass 2 takes a
# signal's chunks 32 at a time, in order, so fewer chunks cost it less. Chunks are no
# shorter than MIN_CHUNK steps.
THREADS_PER_SM = 256
MIN_CHUNK = 256


def chunk_length(T: int, n: int, sm_count: int) -> int:
    """Steps a chunk for (T, n) residuals on a card of ``sm_count`` SMs: chunks enough
    that chunks x n threads fill the card, or T (one chunk) when n alone fills it or
    T is short."""
    chunks = -(-(sm_count * THREADS_PER_SM) // max(n, 1))
    if chunks <= 1 or T <= MIN_CHUNK:
        return max(T, 1)
    return min(max(MIN_CHUNK, -(-T // chunks)), T)


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load(SOURCE).sprt_launch
        pointers, floats = [ctypes.c_void_p] * 5, [ctypes.c_float] * 5
        # r, mu, sigma, alarms, llr, T, n, L, m_pos, m_neg, half_m2, upper, lower, rerun,
        # device, stream
        fn.argtypes = pointers + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong] + floats
        fn.argtypes += [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def sprt_cuda(
    residuals, sigma, mu, m_shift: float, upper: float, lower: float, *, chunk=None, reruns=None
):
    """residuals (T, n), sigma and mu (n,) (mu may be None), CUDA tensors on one device
    -> (alarms (T, n) bool, llr_pos, llr_neg (T, n) f32 views of one (T, 2, n) array).

    Inputs of another float dtype are converted to float32, as the plain version
    converts them, and made contiguous; the kernel reads (T, n) row-major.
    ``chunk`` (steps a chunk, at least 1) overrides ``chunk_length``'s choice; a chunk
    of T or more is the one-chunk path. ``reruns``, a (2,) int64 tensor on the same
    device, gets pass 2's re-run steps added to [0] and [1] raised to the most re-run
    in one chunk of one signal."""
    global launches
    _build.refuse_dtensors("sprt_cuda", residuals, sigma, mu)
    vecs = [v for v in (sigma, mu) if v is not None]
    tensors = [residuals, *vecs] + ([] if reruns is None else [reruns])
    if not all(v.is_cuda and v.device == residuals.device for v in tensors):
        devs = [str(v.device) for v in tensors]
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
    if chunk is not None and (isinstance(chunk, bool) or int(chunk) != chunk or chunk < 1):
        raise ValueError(f"chunk must be a whole number of steps >= 1, got {chunk!r}")
    if reruns is not None and (
        reruns.dtype != torch.int64 or reruns.shape != (2,) or not reruns.is_contiguous()
    ):
        raise ValueError("reruns must be a contiguous (2,) int64 tensor")
    r = residuals.float().contiguous()
    sig = sigma.float().contiguous()
    mu32 = None if mu is None else mu.float().contiguous()
    alarms = torch.empty((T, n), dtype=torch.bool, device=r.device)
    llr = torch.empty((T, 2, n), dtype=torch.float32, device=r.device)
    if T == 0 or n == 0:
        return alarms, llr[:, 0], llr[:, 1]
    index = r.device.index if r.device.index is not None else torch.cuda.current_device()
    if chunk is None:
        chunk = chunk_length(T, n, torch.cuda.get_device_properties(index).multi_processor_count)
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
        min(int(chunk), T),
        M,
        -M,
        0.5 * M * M,
        upper,
        lower,
        None if reruns is None else reruns.data_ptr(),
        index,
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sprt kernel launch failed with CUDA error {err}")
    launches += 1
    return alarms, llr[:, 0], llr[:, 1]
