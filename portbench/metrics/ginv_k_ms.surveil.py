"""Device milliseconds a batch of the kernels launched inside the program's
``mset2.estimate.ginv_k`` span: the product W = Ginv K (K4, the 3xTF32
tensor-core GEMM, and its split passes)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"^mset2\.estimate\.ginv_k$")
    return s / run.units * 1e3 if s > 0 else None
