"""SPRT (Sequential Probability Ratio Test) fault detection on MSET residuals —
the alarming stage that gives MSET2 its "ultra-low false/missed-alarm
probabilities" (paper §II.B). Two-sided mean-shift test, vectorized over signals.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._telemetry import device_counter, span
from repro_torch.kernels.sprt import sprt_scan

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

    The recursion is one CUDA kernel for residuals on the card (K3) and the plain
    loop over time for residuals on the CPU (``kernels.sprt``), inside the span
    ``mset2.sprt``. With a telemetry session open, K3 adds its pass-2 re-run steps to
    the session's counter ``sprt_rerun_steps_total``.
    """
    reruns = (
        device_counter("sprt_rerun_steps_total", residuals.device, size=2)
        if residuals.is_cuda
        else None
    )
    with span("mset2.sprt"):
        return sprt_scan(
            residuals, sigma, mu, m_shift=p.m_shift, upper=p.upper, lower=p.lower, reruns=reruns
        )


def empirical_false_alarm_rate(alarms) -> torch.Tensor:
    return torch.mean(alarms.float())
