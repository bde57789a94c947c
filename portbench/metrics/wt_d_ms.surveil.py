"""Device milliseconds a unit (a batch of the stream) of the kernels launched inside the
program's ``mset2.estimate.wt_d`` span: the product X_hat = W^T D (cuBLAS f32)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"^mset2\.estimate\.wt_d$")
    return s / run.units * 1e3 if s > 0 else None
