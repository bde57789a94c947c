"""Plain PyTorch versions of the two-sided SPRT recursion (the MSET2 alarm stage).

``sprt_ref`` is the CPU path and the yardstick the CUDA kernel (K3) is held against on
the card: a loop over time on the residuals' device, four launches a step, writing
straight into the outputs. ``sprt_chunked_ref`` is a model of the kernel's algorithm
(a speculative pass over chunks of time, then an exact fix-up pass), for the tests;
nothing on the main path calls it.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _increments(residuals, sigma, mu, m_shift: float):
    """(T, 2, n) log-likelihood ratio increments, [positive, negative] a step."""
    r = residuals.float()
    if mu is not None:
        r = r - mu[None, :].float()
    r = r / sigma[None, :].float()
    M = m_shift
    # H1: mean=+M vs H0: mean=0 (unit var)
    return torch.stack([M * r - 0.5 * M * M, -M * r - 0.5 * M * M], dim=1)


def _step(prev, inc, s, hit, upper: float, lower: float):
    """One step of the recursion into ``s`` and ``hit`` (any matching shapes)."""
    torch.add(prev, inc, out=s)
    s.clamp_(min=lower)
    torch.ge(s, upper, out=hit)
    s.masked_fill_(hit, 0.0)  # reset after decision (classic SPRT restart)


def sprt_ref(residuals, sigma, mu, m_shift: float, upper: float, lower: float):
    """residuals (T, n); sigma, mu (n,) or mu None -> (alarms (T, n) bool,
    llr_pos (T, n) f32, llr_neg (T, n) f32), the LLRs views of one (T, 2, n) array."""
    inc = _increments(residuals, sigma, mu, m_shift)
    T, _, n = inc.shape
    llr = torch.empty((T, 2, n), dtype=F32, device=inc.device)
    hit = torch.empty((T, 2, n), dtype=torch.bool, device=inc.device)
    prev = torch.zeros((2, n), dtype=F32, device=inc.device)
    for t in range(T):
        _step(prev, inc[t], llr[t], hit[t], upper, lower)
        prev = llr[t]
    alarms = hit[:, 0] | hit[:, 1]
    return alarms, llr[:, 0], llr[:, 1]


def _same_bits(a, b):
    """(2, n) pairs -> (n,): both sums equal as bits (NaN and signed zeros included)."""
    return (a.view(torch.int32) == b.view(torch.int32)).all(dim=0)


def sprt_chunked_ref(residuals, sigma, mu, m_shift: float, upper: float, lower: float, chunk: int):
    """``sprt_ref``'s function computed as the CUDA kernel computes it, in chunks of
    ``chunk`` steps -> (alarms, llr_pos, llr_neg, reruns), the first three as
    ``sprt_ref`` returns them and ``reruns`` (C, n) int64: the steps pass 2 re-ran in
    each chunk of each signal (row 0, the first chunk, is never re-run).

    Pass 1 runs every chunk at once, the first from (0, 0) and each later one from
    (lower, lower). Pass 2 takes chunks 1 .. C-1 in order: a chunk's true start is the
    pair stored at the step before it, and the chunk is re-run from there, rewriting
    each step, while the re-run state entering a step differs in its bits from pass
    1's state entering it."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    inc = _increments(residuals, sigma, mu, m_shift)
    T, _, n = inc.shape
    dev = inc.device
    L = min(chunk, max(T, 1))
    C = -(-T // L)
    # pass 1: each chunk's L steps at once over (C, 2, n), the last chunk padded
    padded = torch.zeros((C * L, 2, n), dtype=F32, device=dev)
    padded[:T] = inc
    padded = padded.view(C, L, 2, n)
    llr = torch.empty((C, L, 2, n), dtype=F32, device=dev)
    hit = torch.empty((C, L, 2, n), dtype=torch.bool, device=dev)
    prev = torch.full((C, 2, n), lower, dtype=F32, device=dev)
    prev[:1] = 0.0
    for u in range(L):
        _step(prev, padded[:, u], llr[:, u], hit[:, u], upper, lower)
        prev = llr[:, u]
    llr = llr.view(C * L, 2, n)[:T].contiguous()
    hit = hit.view(C * L, 2, n)[:T].contiguous()
    # pass 2: every signal at once, chunk by chunk
    reruns = torch.zeros((C, n), dtype=torch.int64, device=dev)
    guess = torch.full((2, n), lower, dtype=F32, device=dev)
    s = torch.empty((2, n), dtype=F32, device=dev)
    h = torch.empty((2, n), dtype=torch.bool, device=dev)
    for c in range(1, C):
        t, t1 = c * L, min(T, (c + 1) * L)
        true, seen = llr[t - 1].clone(), guess  # seen: pass 1's state entering step t
        active = ~_same_bits(true, seen)
        while t < t1 and bool(active.any()):
            _step(true, inc[t], s, h, upper, lower)
            seen = llr[t].clone()
            llr[t][:, active] = s[:, active]
            hit[t][:, active] = h[:, active]
            reruns[c] += active
            true = torch.where(active, s, true)
            active &= ~_same_bits(true, seen)
            t += 1
    alarms = hit[:, 0] | hit[:, 1]
    return alarms, llr[:, 0], llr[:, 1], reruns
