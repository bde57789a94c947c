"""Device milliseconds a unit of the kernels launched inside the program's
``lm.attention`` span: the attention layers' projections, K2 and the output
projection."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"^lm\.attention$")
    return s / run.units * 1e3 if s > 0 else None
