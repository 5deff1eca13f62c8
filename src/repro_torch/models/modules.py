"""Minimal functional param system: params are nested dicts of tensors.

Port of ``repro/models/modules.py``. Initialisers draw from a seeded
``numpy.random.Generator`` (f32 normals, then cast), with the
reference's shapes, dtypes and scales; the numbers differ from the
reference's ``jax.random`` ones. Weights that must equal the
reference's come across through :mod:`repro_torch.bridge` instead.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# Values drawn per slab: bounds the host's f32 staging (256 MB) however
# large the leaf (a DeepSeek-V3 expert leaf holds 3.76 G values).
SLAB_VALUES = 1 << 26


def normal_init(rng: np.random.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """Normals * scale, drawn in C-order slabs along the leading dim.
    The generator fills each slab in C order, so the slabs concatenate
    to exactly the values one whole-leaf draw would give."""
    shape = tuple(shape)
    row = int(np.prod(shape[1:], dtype=np.int64))
    step = max(1, SLAB_VALUES // max(row, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        a = rng.standard_normal(size=(n,) + shape[1:], dtype=np.float32)
        a *= np.float32(scale)
        out[i:i + n] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return out


def dense_init(rng, d_in: int, d_out: int, dtype, device, *,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return normal_init(rng, (d_in, d_out), scale, dtype, device)


def embed_init(rng, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal_init(rng, (vocab, d), 0.02, dtype, device)


def ones_init(shape, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def iter_leaves(tree) -> Iterable[torch.Tensor]:
    """Every tensor of a nested dict/list param tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(p.numel() for p in iter_leaves(params))
