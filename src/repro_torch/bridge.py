"""Carry the reference's parameters into the port.

:func:`params_from_reference` takes the reference ``init_params`` tree
as plain numpy arrays (the caller converts the framework arrays, e.g.
with ``np.asarray``) and returns the port's tree: the same dicts, with
the layer-stacked ``"stack"`` leaves unstacked into one dict per layer.
bfloat16 arrays (numpy dtype name ``"bfloat16"``) are carried over bit
for bit through their 16-bit patterns. This module imports neither the
reference package nor its framework.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_tensor(arr, device) -> torch.Tensor:
    """numpy array -> tensor on ``device``, bf16 bit-exact."""
    a = np.array(arr, copy=True, order="C")  # owned, writable
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.shape(tree)[0])


def _layer(tree, i: int, device):
    if isinstance(tree, dict):
        return {k: _layer(v, i, device) for k, v in tree.items()}
    return to_tensor(np.asarray(tree)[i], device)


def unstack_layers(stacked: Dict[str, Any], device) -> List[Dict[str, Any]]:
    """{leaf: (L, ...)} -> [{leaf: (...)}] * L."""
    return [_layer(stacked, i, device) for i in range(_n_layers(stacked))]


def params_from_reference(tree: Dict[str, Any], device="cuda"
                          ) -> Dict[str, Any]:
    """The reference's dense-family param tree (numpy leaves) as the
    port's param tree on ``device``."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        out[key] = (unstack_layers(val, dev) if key == "stack"
                    else _convert(val, dev))
    return out
