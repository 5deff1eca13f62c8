"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: the
default device is ``"cuda"``, and asking for it on a host without a
usable CUDA device raises instead of silently running elsewhere. The
``"meta"`` device (shapes and dtypes, no data: the dry run's trace) is
taken only when named.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; ``"cuda"`` without an index is
    the calling thread's current card, made explicit (a thread launching
    for it later, such as an engine thread, selects it by index)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU (where every kernel runs its plain PyTorch version)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
