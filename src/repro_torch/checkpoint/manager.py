"""Fault-tolerant checkpointing: atomic, async-capable.

Port of ``repro/checkpoint/manager.py``, with its on-disk layout:

  <dir>/step_00000123.tmp/...   (written, then atomically renamed)
  <dir>/step_00000123/ arrays.npz (``leaf_i``) + meta.json
  <dir>/LATEST                  (text pointer, written last)

A crash mid-save leaves only a ``.tmp`` directory, which restore
ignores; LATEST always names a complete checkpoint. The leaves are those
of the port's own tree (nested dicts / lists / tuples of tensors, dict
keys sorted), saved as numpy arrays on the host: bf16 as f32 (exact),
cast back to the requested leaf's dtype on restore.

On a mesh (``shard=(mesh, specs)``, ``specs`` one spec per leaf in
``iter_leaves`` order) :func:`save` assembles every leaf whole on rank
0 alone (:func:`gather_to_root`: each distinct slice is sent to it once)
and rank 0 writes it in the single-host format, so the two cannot drift
apart; :func:`restore` with a ``shard`` cuts this rank's slices of
any mesh's layout (or of none) out of the whole arrays: the reference's
elastic re-sharding.
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


def gather_whole(leaves, specs, mesh) -> List[torch.Tensor]:
    """Each of this rank's slices gathered whole over its spec's axes
    (every rank must call it, with the same specs)."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    out = []
    for x, spec in zip(leaves, specs):
        for d, axes in enumerate(spec):
            if axes is None:
                continue
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            # Row-major over the named axes: gather the last one first.
            for a in reversed(names):
                if mesh.shape.get(a, 1) > 1:
                    x = collectives.all_gather(x, a, mesh, dim=d)
        out.append(x)
    return out


def gather_to_root(leaves, specs, mesh) -> Optional[List[torch.Tensor]]:
    """Each leaf whole on rank 0, assembled from the ranks' slices; None
    on every other rank (every rank must call it, with the same specs).
    Each distinct block of a sharded leaf is sent once, by the lowest
    rank holding it, in one flat buffer per sender and dtype; replicated
    leaves do not move."""
    from repro_torch.parallel import collectives  # noqa: PLC0415
    from repro_torch.parallel.sharding import block_index  # noqa: PLC0415

    owner = []  # per leaf: {block index: lowest rank holding it}
    for spec in specs:
        blocks = {}
        for r in range(mesh.size):
            blocks.setdefault(block_index(spec, mesh, r), r)
        owner.append(blocks)

    def sent_by(r):  # the leaves rank r sends, grouped by dtype
        groups = {}
        for i, blocks in enumerate(owner):
            if len(blocks) > 1 and r in blocks.values():
                groups.setdefault(leaves[i].dtype, []).append(i)
        return [groups[k] for k in sorted(groups, key=str)]

    if mesh.rank != 0:
        for idx in sent_by(mesh.rank):
            collectives.send(torch.cat([leaves[i].reshape(-1) for i in idx]),
                             0, mesh)
        return None
    out = list(leaves)
    for i, blocks in enumerate(owner):
        if len(blocks) > 1:
            x = leaves[i]
            shape = list(x.shape)
            for d, _, n in block_index(specs[i], mesh, 0):
                shape[d] *= n
            out[i] = x.new_empty(shape)
            _place(out[i], x, specs[i], mesh, 0)
    for r in range(1, mesh.size):
        for idx in sent_by(r):
            flat = torch.empty(sum(leaves[i].numel() for i in idx),
                               dtype=leaves[idx[0]].dtype,
                               device=leaves[idx[0]].device)
            collectives.recv(flat, r, mesh)
            off = 0
            for i in idx:
                k = leaves[i].numel()
                _place(out[i], flat[off:off + k].view_as(leaves[i]),
                       specs[i], mesh, r)
                off += k
    return out


def _place(whole, part, spec, mesh, rank) -> None:
    """Copy rank ``rank``'s block ``part`` into its place in ``whole``."""
    from repro_torch.parallel.sharding import block_index  # noqa: PLC0415

    view = whole
    for d, idx, _ in block_index(spec, mesh, rank):
        view = view.narrow(d, idx * part.shape[d], part.shape[d])
    view.copy_(part)


def save(directory: str, step: int, tree: Any, *,
         meta: Optional[dict] = None, async_: bool = False,
         shard: Optional[Tuple[Any, list]] = None
         ) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step``. The leaves are copied to the host
    first; with ``async_`` the files are written on a returned thread
    while the caller goes on training. With ``shard`` rank 0 gathers the
    leaves whole and only rank 0 writes (the others return None); a
    synchronous save returns on every rank once the files are on disk."""
    leaves = list(iter_leaves(tree))
    if shard is not None:
        mesh, specs = shard
        leaves = gather_to_root(leaves, specs, mesh)
        if mesh.rank != 0:
            if not async_:
                _barrier(mesh)  # rank 0's files are on disk on return
            return None
    host_leaves = [_to_numpy(x) for x in leaves]
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
    if shard is not None:
        _barrier(shard[0])
    return None


def _barrier(mesh) -> None:
    import torch.distributed as dist  # noqa: PLC0415

    dist.barrier(group=mesh.control)


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
            device=None, shard: Optional[Tuple[Any, list]] = None
            ) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like`` (each leaf in its dtype, on
    ``device``, else on that leaf's device). With ``shard`` (a mesh and
    one spec per leaf) each leaf is this rank's slice of the saved whole
    array, whatever layout wrote it. Returns (tree, step, meta)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(final, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"]
                  for i in range(len(list(iter_leaves(like))))]
    if shard is not None:
        from repro_torch.parallel.sharding import shard_of  # noqa: PLC0415

        mesh, specs = shard
        arrays = [shard_of(torch.from_numpy(np.array(a)), spec, mesh,
                           mesh.rank).numpy()
                  for a, spec in zip(arrays, specs)]
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
