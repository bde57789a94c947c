"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, SHAPES

_ARCH_MODULES = {
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.SMOKE if smoke else mod.CONFIG


def all_cells() -> list[tuple[str, str]]:
    """All 40 (arch x shape) cells, including inapplicable ones (caller filters)."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
