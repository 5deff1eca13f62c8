"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: the
default device is ``"cuda"``, and asking for it on a host without a
usable CUDA device raises instead of silently running elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU (where every kernel runs its plain PyTorch version)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
