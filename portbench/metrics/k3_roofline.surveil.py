"""Per cent of K3's roofline: 13 bytes an element of a batch at HBM's rate over K3's
device time a batch (both passes)."""

from portbench.counts import k3_seconds_at_roofline


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s(r"sprt_") / run.units
    if s <= 0:
        return None
    c = run.cell.config
    return 100.0 * k3_seconds_at_roofline(c["surveil_batch"], c["n_signals"]) / s
