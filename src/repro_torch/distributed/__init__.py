"""The mesh-free part of the JAX package's ``distributed/``: int8 gradient
compression and the training supervisor's fault handling. ``sharding.py`` (the
logical-axis rules, on a device mesh) is not ported yet."""

from repro_torch.distributed import compression, fault

__all__ = ["compression", "fault"]
