"""Seconds from the process's start to the window's: imports, data, the kernels' build
on a first run, training, calibration, host buffers and warm-up."""


def read(run):
    return run.setup_s
