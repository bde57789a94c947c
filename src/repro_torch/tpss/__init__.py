from repro_torch.tpss.synth import (
    TPSSDraws,
    TPSSParams,
    draw,
    inject_anomaly,
    synthesize,
    synthesize_batch,
    synthesize_from_draws,
)

__all__ = [
    "TPSSParams",
    "TPSSDraws",
    "draw",
    "synthesize_from_draws",
    "synthesize",
    "synthesize_batch",
    "inject_anomaly",
]
