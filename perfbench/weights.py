"""Seeded weights made on the device, in the type they are served in.

The tree is the port's own (``init_params(cfg, device="meta")`` gives
every leaf's shape and dtype and draws nothing); the values come from
one ``torch.Generator`` on the run's device, drawn a scale group at a
time into one flat buffer per group, of which every leaf is a view. The
scales are the port's initialisers' rule, copied here so that the
weights stay the benchmark's: an embedding table 0.02, a matrix
``d_in ** -0.5``, a norm's scale ones, a bias zeros.

Both sides of a check get these same weights: the program serves or
trains them, and the plain reference upcasts them layer by layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

# Leaf offsets inside a group's buffer are rounded up to this many
# elements, so every view starts on a 512-byte boundary in bf16.
ALIGN = 256
# Values drawn by one call of the generator: bounds the transient of a
# draw whatever the group's size.
DRAW_VALUES = 1 << 30


def leaf_scale(path: Tuple[str, ...], shape) -> float | None:
    """The port's initialiser's scale for the leaf at ``path`` (dict
    keys and list indices), or None for a constant leaf (a norm's scale
    is ones, a bias zeros)."""
    key = path[-1]
    if key == "scale":
        return None
    if key.startswith("b") and len(shape) == 1:
        return None
    if key == "embed":
        return 0.02
    return float(shape[0]) ** -0.5


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _set(tree, path, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    last = path[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def make_params(meta_tree, seed: int, device) -> Dict[str, Any]:
    """The leaves of ``meta_tree`` (shapes and dtypes on the meta
    device) filled on ``device`` from ``seed``: one buffer and a few
    generator calls per (dtype, scale) group, every leaf a view of its
    group's buffer. The same seed gives the same values on the same
    kind of device."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    groups: Dict[Tuple[torch.dtype, float], List[Tuple[tuple, tuple, int]]] = {}
    out = _copy_structure(meta_tree)
    for path, leaf in _walk(meta_tree):
        scale = leaf_scale(path, leaf.shape)
        if scale is None:
            fill = 1.0 if path[-1] == "scale" else 0.0
            _set(out, path, torch.full(tuple(leaf.shape), fill,
                                       dtype=leaf.dtype, device=dev))
            continue
        groups.setdefault((leaf.dtype, scale), []).append(
            (path, tuple(leaf.shape), leaf.numel()))
    for (dtype, scale), leaves in sorted(groups.items(),
                                         key=lambda kv: (str(kv[0][0]),
                                                         kv[0][1])):
        offsets, total = [], 0
        for _, _, n in leaves:
            offsets.append(total)
            total += -(-n // ALIGN) * ALIGN
        buf = torch.empty((total,), dtype=dtype, device=dev)
        for s0 in range(0, total, DRAW_VALUES):
            part = buf[s0:s0 + DRAW_VALUES]
            part.normal_(0.0, 1.0, generator=gen)
            part.mul_(scale)
        for (path, shape, n), off in zip(leaves, offsets):
            _set(out, path, buf[off:off + n].view(shape))
    return out


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_structure(v) for v in tree]
    return None


def iter_named(tree):
    """(dotted path, leaf) of every leaf, in a fixed order."""
    for path, leaf in _walk(tree):
        yield ".".join(path), leaf
