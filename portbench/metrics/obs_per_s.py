"""Observations whose alarms reached host memory, over the window's seconds."""


def read(run):
    return run.units * run.unit_obs / run.window_s if run.units else None
