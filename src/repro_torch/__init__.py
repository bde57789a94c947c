"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The package mirrors ``repro/`` path for path and never imports ``jax`` or
``repro``. Entry points that create tensors default to ``device="cuda"`` and
raise when no card is present; pass ``device="cpu"`` to run on the CPU.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
