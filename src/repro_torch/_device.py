"""Device resolution for the port's entry points.

``device=None`` means the card. The CPU is used only when the caller asks for it:
a measurement that silently fell back to the CPU would report CPU numbers under
the GPU's name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the torch device to create tensors on (``None`` -> ``"cuda"``).

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def sync() -> None:
    """Wait for the work queued on the card, so that a clock read after it counts
    that work. CPU tensors compute synchronously."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def f32_matmul_highest() -> None:
    """Keep float32 products in full IEEE float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
