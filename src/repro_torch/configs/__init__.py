"""Architecture config registry: ``get_config(name)`` / ``--arch <id>``.

Knows only the archs the port serves so far, plus ``paper-alexnet``
(the GEMM layer table of the paper's figures), which ``ARCH_NAMES``
leaves out as the reference's does.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MLAConfig, MoEConfig, SSMConfig,
)

_ARCH_MODULES: Dict[str, str] = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "paper-alexnet": "repro_torch.configs.paper_alexnet",
}

ARCH_NAMES = tuple(n for n in _ARCH_MODULES if n != "paper-alexnet")


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; the port serves: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG
