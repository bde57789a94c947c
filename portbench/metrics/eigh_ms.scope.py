"""Device milliseconds a cell of the kernels launched inside ``linalg_eigh`` (cuSOLVER's
symmetric eigensolver, the training's pseudo-inverse)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"linalg_eigh")
    return s / run.units * 1e3 if s > 0 else None
