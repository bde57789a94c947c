"""Device milliseconds a batch of the kernels whose names hold ``gemm``: K4's (W = Ginv K
and its split passes) and cuBLAS's (W^T D)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s(r"gemm")
    return s / run.units * 1e3 if s > 0 else None
