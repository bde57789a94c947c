from repro_torch.mset.mset2 import MSETModel, estimate, surveil, train
from repro_torch.mset.pluggable import REGISTRY, get_plugin
from repro_torch.mset.sprt import SPRTParams, empirical_false_alarm_rate, sprt

__all__ = [
    "MSETModel",
    "train",
    "estimate",
    "surveil",
    "sprt",
    "SPRTParams",
    "empirical_false_alarm_rate",
    "REGISTRY",
    "get_plugin",
]
