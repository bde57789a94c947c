"""Per cent of the TF32 peak (495 TFLOP/s) that the batches completed in the window
make of it: K1 (2 m b n), Ginv K (2 m^2 b) and W^T D (2 b m n) a batch."""

from portbench.counts import PEAK_TF32_FLOPS, surveil_flops


def read(run):
    if not run.units:
        return None
    c = run.cell.config
    flops = surveil_flops(c["n_memvec"], c["surveil_batch"], c["n_signals"]) * run.units
    return 100.0 * flops / run.window_s / PEAK_TF32_FLOPS
