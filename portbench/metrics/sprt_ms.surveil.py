"""Milliseconds a batch of ``sprt`` (K3 and its wrapper), between CUDA events on the
compute stream, mean over the window."""

from statistics import fmean


def read(run):
    t = run.timers_ms.get("sprt")
    return fmean(t) if t else None
