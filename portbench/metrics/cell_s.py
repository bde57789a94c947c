"""Seconds a Monte Carlo scoping cell: the window over the cells it completed."""


def read(run):
    return run.window_s / run.units if run.units else None
