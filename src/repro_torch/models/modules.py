"""Minimal functional param system: params are nested dicts of tensors.

Port of ``repro/models/modules.py``. Initialisers draw from a seeded
``numpy.random.Generator`` (f32 normals, then cast; each leaf in chunks
drawn on several threads, see :func:`normal_init`), with the
reference's shapes, dtypes and scales; the numbers differ from the
reference's (its framework's counter-based generator). Weights that must equal the
reference's come across through :mod:`repro_torch.bridge` instead.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# Values per chunk: a leaf's values, in C order, are chunks of this many,
# each drawn from its own generator, so threads can draw several at once
# (numpy fills without the interpreter lock) and the values depend on
# neither the thread count nor the staging.
CHUNK_VALUES = 1 << 22
# Values staged on the host per copy to the device (whole chunks): bounds
# the f32 staging (256 MB) however large the leaf (a DeepSeek-V3 expert
# leaf holds 3.76 G values).
SLAB_VALUES = 1 << 26
# Threads drawing the chunks of a slab.
INIT_THREADS = max(1, min(8, os.cpu_count() or 1))


def normal_init(rng: np.random.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """Normals * scale. The leaf takes one seed from ``rng``; chunk ``c``
    of its values (C order) is ``default_rng([seed, c])``'s f32 normals,
    scaled, then cast. On the meta device the leaf has its shape and
    dtype and nothing is drawn."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    seed = int(rng.integers(1 << 63))
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1)
    slab = max(1, SLAB_VALUES // CHUNK_VALUES) * CHUNK_VALUES
    buf = np.empty((min(slab, n),), np.float32)

    def draw(start: int, view: np.ndarray) -> None:
        g = np.random.default_rng([seed, start // CHUNK_VALUES])
        g.standard_normal(dtype=np.float32, out=view)
        view *= np.float32(scale)

    pool = (ThreadPoolExecutor(INIT_THREADS)
            if n > CHUNK_VALUES and INIT_THREADS > 1 else None)
    try:
        for s0 in range(0, n, slab):
            m = min(slab, n - s0)
            jobs = [(s0 + c, buf[c:min(c + CHUNK_VALUES, m)])
                    for c in range(0, m, CHUNK_VALUES)]
            if pool is None:
                for job in jobs:
                    draw(*job)
            else:
                for f in [pool.submit(draw, *job) for job in jobs]:
                    f.result()
            flat[s0:s0 + m] = torch.from_numpy(buf[:m]).to(
                device=device, dtype=dtype)
    finally:
        if pool is not None:
            pool.shutdown()
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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / lists / tuples (named
    tuples kept), ``rest`` trees of the same structure alongside; leaves
    are visited in :func:`iter_leaves` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def param_count(params) -> int:
    return sum(p.numel() for p in iter_leaves(params))


def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in iter_leaves(params))
