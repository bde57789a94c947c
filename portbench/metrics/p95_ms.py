"""The 95th percentile (nearest rank) of every batch's latency in the window, from its
submission on the host to its alarms and LLRs being in host memory."""

from portbench.stats import percentile


def read(run):
    return percentile(run.latencies_ms, 95) if run.latencies_ms else None
