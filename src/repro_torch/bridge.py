"""Carry the reference's parameters into the port.

:func:`params_from_reference` takes the reference ``init_params`` tree
as plain numpy arrays (the caller converts the framework arrays, e.g.
with ``np.asarray``) and returns the port's tree: the same dicts, with
the layer-stacked ``"stack"`` and ``"dense_stack"`` leaves (MoE layers'
router, ``(E, d, de)`` expert tensors and shared expert included, or
the ssm family's mamba2 mixers) unstacked into one dict per layer, and
the hybrid family's ``"hybrid"`` tree carried as the port holds it:
``"groups"`` (leading dims ``(n_super, every)``) as a list of lists of
layer dicts, ``"shared_attn"`` as one dict, ``"trailing"`` as a list.
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


def _index(tree, i: int):
    """{leaf: (n, ...)} -> {leaf: (...)} at index ``i``, still numpy."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def hybrid_from_reference(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference's ``"hybrid"`` subtree as the port's."""
    out: Dict[str, Any] = {
        "groups": [unstack_layers(_index(tree["groups"], g), device)
                   for g in range(_n_layers(tree["groups"]))],
        "shared_attn": _convert(tree["shared_attn"], device),
    }
    if "trailing" in tree:
        out["trailing"] = unstack_layers(tree["trailing"], device)
    return out


def params_from_reference(tree: Dict[str, Any], device="cuda"
                          ) -> Dict[str, Any]:
    """The reference's param tree of any family (numpy leaves) as the
    port's param tree on ``device``; the audio frontend's ``embed``
    (K, V, d) and ``heads`` (K, d, V) come across as they are."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if key in STACKS:
            out[key] = unstack_layers(val, dev)
        elif key == "hybrid":
            out[key] = hybrid_from_reference(val, dev)
        else:
            out[key] = _convert(val, dev)
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
