"""Device milliseconds a cell of K1, the similarity kernel and its split pre-pass, over
both of a cell's calls: D x D in training and D x X in the estimate."""


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s(r"similarity|split_kernel")
    return s / run.units * 1e3 if s > 0 else None
