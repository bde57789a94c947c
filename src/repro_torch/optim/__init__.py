from repro_torch.optim.adamw import AdamWConfig, AdamWState, global_norm, init, update
from repro_torch.optim.grad_accum import microbatched_value_and_grad
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "init",
    "update",
    "global_norm",
    "microbatched_value_and_grad",
    "warmup_cosine",
    "constant",
]
