"""Fault-tolerant checkpointing: atomic, async-capable.

Port of ``repro/checkpoint/manager.py``, with its on-disk layout:

  <dir>/step_00000123.tmp/...   (written, then atomically renamed)
  <dir>/step_00000123/ arrays.npz (``leaf_i``) + meta.json
  <dir>/LATEST                  (text pointer, written last)

A crash mid-save leaves only a ``.tmp`` directory, which restore
ignores; LATEST always names a complete checkpoint. The leaves are those
of the port's own tree (nested dicts / lists / tuples of tensors, dict
keys sorted), saved as numpy arrays on the host: bf16 as f32 (exact),
cast back to the requested leaf's dtype on restore. Restoring onto
another layout (the reference's elastic re-sharding) waits for the
multi-device port.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.modules import iter_leaves, tree_map


def _paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path, in :func:`iter_leaves` order: the tree's
    structure as ``meta.json`` records it."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix or "/"]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()  # numpy has no bf16; f32 holds it exactly
        return x.cpu().numpy()
    return np.asarray(x)


def save(directory: str, step: int, tree: Any, *,
         meta: Optional[dict] = None,
         async_: bool = False) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step``. The leaves are copied to the host
    first; with ``async_`` the files are written on a returned thread
    while the caller goes on training."""
    host_leaves = [_to_numpy(x) for x in iter_leaves(tree)]
    structure = _paths(tree)

    def _write():
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "treedef": structure, **(meta or {})},
                      f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(directory, "LATEST.tmp"),
                   os.path.join(directory, "LATEST"))

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return [int(m.group(1)) for d in os.listdir(directory)
            if (m := re.fullmatch(r"step_(\d+)", d))]


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        # Fall back to scanning (the LATEST write could have been cut).
        steps = _steps(directory)
        return max(steps) if steps else None
    with open(p) as f:
        name = f.read().strip()
    m = re.fullmatch(r"step_(\d+)", name)
    return int(m.group(1)) if m else None


def restore(directory: str, like: Any, *, step: Optional[int] = None,
            device=None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like`` (each leaf in its dtype, on
    ``device``, else on that leaf's device). Returns (tree, step, meta)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(final, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"]
                  for i in range(len(list(iter_leaves(like))))]
    it = iter(arrays)

    def one(leaf):
        t = torch.from_numpy(np.array(next(it)))  # owned, 0-d kept
        if isinstance(leaf, torch.Tensor):
            return t.to(device=device if device is not None else leaf.device,
                        dtype=leaf.dtype)
        return t
    return tree_map(one, like), step, meta


def cleanup(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in sorted(_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
