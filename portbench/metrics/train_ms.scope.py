"""Milliseconds of MSET2 training a cell (host clock between two synchronizes around
``mset2.train``), in the traced run."""

from statistics import fmean


def read(run):
    t = run.timers_ms.get("train")
    return fmean(t) if t else None
