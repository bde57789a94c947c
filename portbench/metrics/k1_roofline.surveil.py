"""Per cent of K1's roofline: the least time for the similarity of the memory matrix
against a batch (2 m b n operations at the TF32 peak, or D and X read and K written
once at HBM's rate, whichever is longer) over K1's device time a batch, its split
pre-pass included."""

from portbench.counts import k1_seconds_at_roofline


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s(r"similarity|split_kernel") / run.units
    if s <= 0:
        return None
    c = run.cell.config
    return 100.0 * k1_seconds_at_roofline(c["n_memvec"], c["surveil_batch"], c["n_signals"]) / s
