"""Architecture config registry: ``get_config(name)`` / ``--arch <id>``.

The reference's registry: the ten serving archs, plus ``paper-alexnet``
(the GEMM layer table of the paper's figures), which ``ARCH_NAMES``
leaves out as the reference's does.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES, ArchConfig, MLAConfig, MoEConfig, ShapeConfig, SSMConfig,
    shape_by_name,
)

_ARCH_MODULES: Dict[str, str] = {
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "qwen1.5-110b": "repro_torch.configs.qwen1p5_110b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "paper-alexnet": "repro_torch.configs.paper_alexnet",
}

ARCH_NAMES = tuple(n for n in _ARCH_MODULES if n != "paper-alexnet")


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; the port serves: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG
