"""Device milliseconds a unit of the kernels launched inside the program's
``lm.mamba.ssd`` span: the Mamba-2 layers' chunked state-space scan (plain PyTorch)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"^lm\.mamba\.ssd$")
    return s / run.units * 1e3 if s > 0 else None
