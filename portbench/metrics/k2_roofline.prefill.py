"""Per cent of K2's roofline: the least time for the causal attention of a unit's
attention layers (4·B·H·hd·S(S+1)/2 operations at the bf16 peak, or q, k, v and o moved
once at HBM's rate, whichever is longer) over K2's device time a unit, the kernels
launched by the operator ``repro_torch::flash_attention``."""

from portbench.counts_lm import attention_layers, attention_seconds_at_roofline


def read(run):
    if run.trace is None or not run.units:
        return None
    s = run.trace.device_s_under(r"^repro_torch::flash_attention$") / run.units
    if s <= 0:
        return None
    c, tr = run.cell.config, run.cell.traffic
    bound = attention_layers(c) * attention_seconds_at_roofline(c, tr["batch"], tr["prompt_len"])
    return 100.0 * bound / s
