# The tunable-knob spaces of the policy families. The rest of the reference's
# tuning package (evaluate, racing, result, tuner) is not ported yet.
from repro_torch.fleet.tuning.space import (
    Categorical,
    Continuous,
    Dim,
    Integer,
    ParamSpace,
    discipline_dim,
    quota_dims,
)

__all__ = [
    "Categorical",
    "Continuous",
    "Dim",
    "Integer",
    "ParamSpace",
    "discipline_dim",
    "quota_dims",
]
