"""Device milliseconds a batch of the kernels launched inside the program's
``mset2.estimate.standardize`` and ``mset2.estimate.residuals`` spans: the pointwise
passes (X - mean) / std, X_hat * std + mean and X - X_hat."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"^mset2\.estimate\.(standardize|residuals)$")
    return s / run.units * 1e3 if s > 0 else None
