"""SPRT (Sequential Probability Ratio Test) fault detection on MSET residuals —
the alarming stage that gives MSET2 its "ultra-low false/missed-alarm
probabilities" (paper §II.B). Two-sided mean-shift test, vectorized over signals.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

F32 = torch.float32


def _log_f32(v: float) -> float:
    # The reference takes these logs in float32; the float64 value differs in the
    # last digits and would move alarms that land on the threshold.
    return float(torch.log(torch.tensor(v, dtype=F32)))


@dataclass(frozen=True)
class SPRTParams:
    alpha: float = 1e-3  # false-alarm probability
    beta: float = 1e-3  # missed-alarm probability
    m_shift: float = 3.0  # magnitude of mean shift to detect, in sigmas

    @property
    def upper(self) -> float:
        return _log_f32((1 - self.beta) / self.alpha)

    @property
    def lower(self) -> float:
        return _log_f32(self.beta / (1 - self.alpha))


def sprt(residuals, sigma, p: SPRTParams = SPRTParams(), mu=None):
    """residuals: (T, n); sigma/mu: (n,) residual std/mean from clean validation
    data (mu defaults to 0). Returns (alarms (T, n), llr_pos, llr_neg).

    The recursion is a loop over time on the residuals' device, four launches a
    step, writing straight into the outputs.
    """
    r = residuals.float()
    if mu is not None:
        r = r - mu[None, :].float()
    r = r / sigma[None, :].float()
    M = p.m_shift
    # log-likelihood ratio increments for H1: mean=+M vs H0: mean=0 (unit var),
    # stacked (T, 2, n) as [positive, negative]
    inc = torch.stack([M * r - 0.5 * M * M, -M * r - 0.5 * M * M], dim=1)
    hi, lo = p.upper, p.lower

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


def empirical_false_alarm_rate(alarms) -> torch.Tensor:
    return torch.mean(alarms.float())
