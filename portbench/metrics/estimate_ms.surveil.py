"""Milliseconds a batch of ``mset2.estimate`` (standardization, K1, Ginv K, W^T D and
the residuals), between CUDA events on the compute stream, mean over the window."""

from statistics import fmean


def read(run):
    t = run.timers_ms.get("estimate")
    return fmean(t) if t else None
