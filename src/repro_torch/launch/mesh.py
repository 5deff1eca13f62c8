"""Mesh construction over ``torch.distributed``, and a launcher of ranks.

Port of ``repro/launch/mesh.py``. Functions only: importing this module
touches no process group. :func:`make_mesh` builds the rank grid and
every process group of a mesh on an already-initialized world;
:func:`spawn_mesh` starts one process per rank (``torch.multiprocessing``
with the ``spawn`` start method), joins them into a world through a
``FileStore`` in a fresh temporary directory (no TCP port to collide
with another job on the host), builds the mesh in each, and runs a
function there.

:func:`trace_mesh` builds a mesh with no world for the dry run's trace
of one rank's program.

Every process group gets a timeout (``timeout_s``, 60 s or less by
default): a rank that takes another branch, dies or stops answering
makes its peers' collectives raise instead of waiting forever.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import queue as _queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

from repro_torch.parallel.sharding import SERVE_AXES, Mesh

DEFAULT_TIMEOUT_S = 60.0


def _timeout(timeout_s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(timeout_s))


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh ``shape`` over ``axes`` on the initialized world: the
    rank grid (row-major, this rank's coordinates from its rank), this
    rank's process group for every non-empty set of axes (the whole
    world for all of them) and a CPU ``gloo`` control group. Every rank
    must call it, in the same order as its other group creations.
    Raises RuntimeError when no world is initialized or its size is not
    the mesh's."""
    import torch.distributed as dist

    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialized world of {n} ranks "
            "(torch.distributed.init_process_group; see spawn_mesh)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the world has {world}")
    backend = dist.get_backend()
    mesh = Mesh(dict(zip(axes, shape)), rank=dist.get_rank(),
                backend=backend, timeout_s=float(timeout_s))
    me = mesh.coords()
    to = _timeout(timeout_s)
    for k in range(1, len(axes) + 1):
        for names in itertools.combinations(axes, k):
            if k == len(axes):
                mesh.groups[names] = dist.group.WORLD
                continue
            others = [a for a in axes if a not in names]
            # One group per position on the other axes; every rank
            # creates every group, in the same order.
            for pos in itertools.product(*(range(mesh.shape[a])
                                           for a in others)):
                fixed = dict(zip(others, pos))
                ranks = sorted(
                    mesh.rank_at(**fixed, **dict(zip(names, idx)))
                    for idx in itertools.product(
                        *(range(mesh.shape[a]) for a in names)))
                g = dist.new_group(ranks, timeout=to)
                if all(me[a] == fixed[a] for a in others):
                    mesh.groups[names] = g
    # Commands travel on a group of their own, so that a thread sending
    # one never interleaves with collectives on the device groups.
    mesh.control = dist.new_group(backend="gloo", timeout=to)
    return mesh


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh: 16x16 (one pod, 256 ranks)
    or 2x16x16 (two pods, 512 ranks)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The production mesh (:func:`production_mesh_shape`) on an
    initialized world of its size."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, timeout_s=timeout_s)


def trace_mesh(shape: Sequence[int], axes: Sequence[str], *,
               rank: int = 0) -> Mesh:
    """A mesh for tracing rank ``rank``'s program (the dry run): no
    world, no process groups, ``trace`` set, so every collective counts
    and returns its result's shape without moving data
    (``parallel/collectives.py``)."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return Mesh(dict(zip(axes, shape)), rank=rank, trace=True)


# ------------------------------------------------------------ spawning
def _rank_main(rank: int, world: int, shape, axes, store_path: str,
               backend: str, timeout_s: float, device: str, fn: Callable,
               args: tuple, results) -> None:
    """One spawned rank: join the world, build the mesh, run ``fn(mesh,
    *args)``, report ``(rank, "ok", result)`` or ``(rank, "error",
    traceback)`` on ``results``. A failing rank exits at once, so its
    peers' pending collectives fail on the closed connection."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import collectives

    torch.set_num_threads(1)
    status, payload = "ok", None
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=_timeout(timeout_s))
        mesh = make_mesh(shape, axes, timeout_s=timeout_s)
        collectives.set_mesh(mesh)
        payload = fn(mesh, *args)
    except BaseException:  # noqa: BLE001 - reported to the parent
        status, payload = "error", traceback.format_exc()
    results.put((rank, status, payload))
    results.close()
    results.join_thread()
    if status != "ok":
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_mesh(fn: Callable, shape: Sequence[int], args: tuple = (), *,
               device: Union[str, Sequence[str]] = "cpu",
               backend: str = "gloo",
               timeout_s: float = DEFAULT_TIMEOUT_S,
               deadline_s: Optional[float] = None,
               axes: Sequence[str] = SERVE_AXES) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a fresh mesh ``shape``
    over ``axes`` (default: serving's (data, model); training spawns
    ``("pod", "data", "model")[-len(shape):]``) and return the ranks'
    results, by rank.

    ``fn`` must be importable by its module path (a spawned rank starts
    from a fresh interpreter); ``args`` and the results are pickled.
    ``device`` is each rank's device (one for all, or one per rank):
    ``"cuda:0"`` puts every rank on card 0, which only ``gloo`` allows;
    ``backend`` is ``"gloo"`` or ``"nccl"``, never chosen for the
    caller. Each rank runs with one intra-op thread. ``timeout_s``
    bounds every collective's wait; ``deadline_s`` (None: no bound) the
    whole run. When a rank fails, the others get ``timeout_s`` to end,
    then every rank left is killed, and RuntimeError carries the
    failing ranks' tracebacks (the first to fail first)."""
    import torch.multiprocessing as mp

    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    world = math.prod(shape)
    devices = ([device] * world if isinstance(device, str)
               else list(device))
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main, name=f"mesh-rank-{r}",
            args=(r, world, shape, axes, os.path.join(tmp, "store"),
                  backend, timeout_s, devices[r], fn, args, results))
            for r in range(world)]
        for p in procs:
            p.start()
        done: dict = {}
        errors: List[Tuple[int, str]] = []
        t_fail = None
        try:
            while len(done) < world:
                now = time.monotonic()
                if t_end is not None and now > t_end:
                    errors.append((-1, f"deadline of {deadline_s}s passed"))
                    break
                if t_fail is not None and now > t_fail:
                    break
                try:
                    rank, status, payload = results.get(timeout=0.2)
                except _queue.Empty:
                    # A rank that died without reporting (killed, or a
                    # crash in native code) counts as failed.
                    for r, p in enumerate(procs):
                        if r not in done and p.exitcode not in (None, 0):
                            done[r] = None
                            errors.append(
                                (r, f"rank {r} exited with code "
                                    f"{p.exitcode} without a report"))
                            t_fail = t_fail or now + timeout_s
                    continue
                done[rank] = payload
                if status != "ok":
                    errors.append((rank, payload))
                    t_fail = t_fail or time.monotonic() + timeout_s
        finally:
            for p in procs:
                p.join(timeout=max(0.0, 5.0 if not errors else 1.0))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    if errors or len(done) < world:
        missing = [r for r in range(world) if r not in done]
        msg = "\n".join(f"--- rank {r}:\n{tb}" for r, tb in errors)
        if missing:
            msg += f"\n--- ranks {missing} did not finish (killed)"
        raise RuntimeError(f"mesh {shape} failed:\n{msg}")
    return [done[r] for r in range(world)]

