"""Per cent of the bf16 peak (989 TFLOP/s) that the prefills completed in the window
make of it: every layer's products, attention and state-space part, and the head at
each prompt's last token (``counts_lm.prefill_flops``)."""

from portbench.counts_lm import PEAK_BF16_FLOPS, prefill_flops


def read(run):
    if not run.units:
        return None
    tr = run.cell.traffic
    flops = prefill_flops(run.cell.config, tr["batch"], tr["prompt_len"]) * run.units
    return 100.0 * flops / run.window_s / PEAK_BF16_FLOPS
