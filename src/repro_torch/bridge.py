"""Carry the reference's parameters into the port.

:func:`params_from_reference` takes the reference ``init_params`` tree
as plain numpy arrays (the caller converts the framework arrays, e.g.
with ``np.asarray``) and returns the port's tree: the same dicts, with
the layer-stacked ``"stack"`` and ``"dense_stack"`` leaves (MoE layers'
router, ``(E, d, de)`` expert tensors and shared expert included)
unstacked into one dict per layer.
bfloat16 arrays (numpy dtype name ``"bfloat16"``) are carried over bit
for bit through their 16-bit patterns. :func:`plan_from_reference` and
:func:`bitmap_from_reference` carry a reference ``SkipPlan`` and
``TileBitmap`` over the same way (duck-typed: any object with their
fields). This module imports neither the reference package nor its
framework.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.sasa import SkipPlan
from repro_torch.core.sprf import TileBitmap
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


# Layer-stacked subtrees of the reference's tree.
STACKS = ("stack", "dense_stack")


def unstack_layers(stacked: Dict[str, Any], device) -> List[Dict[str, Any]]:
    """{leaf: (L, ...)} -> [{leaf: (...)}] * L."""
    return [_layer(stacked, i, device) for i in range(_n_layers(stacked))]


def params_from_reference(tree: Dict[str, Any], device="cuda"
                          ) -> Dict[str, Any]:
    """The reference's dense- or moe-family param tree (numpy leaves) as
    the port's param tree on ``device``."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        out[key] = (unstack_layers(val, dev) if key in STACKS
                    else _convert(val, dev))
    return out


def plan_from_reference(plan):
    """A reference ``SkipPlan`` as the port's, field for field."""
    return SkipPlan(**{f.name: getattr(plan, f.name)
                       for f in dataclasses.fields(SkipPlan)})


def bitmap_from_reference(bitmap, device="cpu"):
    """A reference ``TileBitmap`` (bits any array numpy can read) as the
    port's, bits int32 on ``device``."""
    return TileBitmap(
        bits=to_tensor(np.asarray(bitmap.bits, np.int32),
                       resolve_device(device)),
        block=tuple(bitmap.block), shape=tuple(bitmap.shape))
