"""The JAX package's ``distributed/``: logical-axis sharding on a ``DeviceMesh``
(``sharding.py``), int8 gradient compression and the training supervisor's fault
handling."""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    Box,
    ShardingRules,
    is_box,
    make_rules,
    unbox_axes,
    unbox_values,
)

__all__ = [
    "Box",
    "ShardingRules",
    "DEFAULT_RULES",
    "is_box",
    "make_rules",
    "unbox_axes",
    "unbox_values",
]
