"""Device milliseconds a batch of the library's GEMM kernels (cuBLAS: Ginv K and W^T D)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s(r"gemm")
    return s / run.units * 1e3 if s > 0 else None
