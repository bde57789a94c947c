"""Device milliseconds a unit of the kernels launched inside the program's ``lm.moe``
span: every layer's MoE (routing, dispatch, the routed experts' products, the shared
expert and the combine)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"^lm\.moe$")
    return s / run.units * 1e3 if s > 0 else None
