"""Plain PyTorch version of the two-sided SPRT recursion (the MSET2 alarm stage).

The CPU path and the yardstick the CUDA kernel (K3) is held against on the card:
a loop over time on the residuals' device, four launches a step, writing straight
into the outputs.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def sprt_ref(residuals, sigma, mu, m_shift: float, upper: float, lower: float):
    """residuals (T, n); sigma, mu (n,) or mu None -> (alarms (T, n) bool,
    llr_pos (T, n) f32, llr_neg (T, n) f32), the LLRs views of one (T, 2, n) array."""
    r = residuals.float()
    if mu is not None:
        r = r - mu[None, :].float()
    r = r / sigma[None, :].float()
    M = m_shift
    # log-likelihood ratio increments for H1: mean=+M vs H0: mean=0 (unit var),
    # stacked (T, 2, n) as [positive, negative]
    inc = torch.stack([M * r - 0.5 * M * M, -M * r - 0.5 * M * M], dim=1)
    hi, lo = upper, lower

    T, n = r.shape
    llr = torch.empty((T, 2, n), dtype=F32, device=r.device)
    hit = torch.empty((T, 2, n), dtype=torch.bool, device=r.device)
    prev = torch.zeros((2, n), dtype=F32, device=r.device)
    for t in range(T):
        s = llr[t]
        torch.add(prev, inc[t], out=s)
        s.clamp_(min=lo)
        torch.ge(s, hi, out=hit[t])
        s.masked_fill_(hit[t], 0.0)  # reset after decision (classic SPRT restart)
        prev = s
    alarms = hit[:, 0] | hit[:, 1]
    return alarms, llr[:, 0], llr[:, 1]
