"""Collectives over a :class:`~repro_torch.parallel.sharding.Mesh`, with
byte accounting.

The reference reads its collective traffic out of compiled HLO
(``repro/parallel/collectives.py:parse_collective_bytes``); the port has
no HLO, so every call here adds its OPERAND bytes to a per-kind counter
on the mesh (``mesh.stats``), with the reference's five kinds and its
operand-byte convention:

    psum            all-reduce          operand == result
    pmax            all-reduce          operand == result
    all_gather      all-gather          operand == result / n
    reduce_scatter  reduce-scatter      operand == result * n
    broadcast       collective-permute  operand == the tensor (counted
                                        on every rank: the root's
                                        sends, the others' receives)
    send, recv      collective-permute  operand == the tensor (each
                                        rank counts its own end)
    ppermute        collective-permute  operand == the tensor (once a
                                        call per rank, whatever it
                                        sends or receives)

(all-to-all has no caller: the sharded training step needs none.) The
reference's ``parse_collective_bytes`` is not ported, by design: there is no HLO to parse, and :func:`stats` gives the
same dict (per-kind bytes, ``total``, ``counts``) from the calls
themselves. Beside the bytes it
counts the calls and the seconds spent in them, host clock around the
blocking call (for a CUDA tensor that includes the wait for the work
queued before it on the stream). A group of one rank costs nothing and
counts nothing.

On a trace mesh (``Mesh.trace``, built by ``launch/mesh.py:trace_mesh``
for the dry run) every collective counts its bytes and calls exactly as
on a real mesh, with 0 seconds, returns a tensor of its result's shape
and dtype and moves no data. A mesh with neither groups nor the flag
raises, as it always did.

:func:`roofline_terms` is the reference's three-term roofline on the
H100's constants.

The process's mesh is set once per rank (:func:`set_mesh`, by
``launch/mesh.py``); model code reaches it through ``cfg.tp_axis``
(:func:`psum` with an axis name) and the sharded training step's plan
(``sharding.TrainPlan``). Nothing here runs on a single host: the model
imports this module only on a mesh.

Training goes through the collectives below as ``torch.autograd``
Functions of the port's own (``torch.distributed.nn``'s all-reduce
all-reduces again in its backward, which multiplies a replicated
gradient by n). Every one of them counts like its plain twin, in its
forward and in its backward:

    tp_close        forward all-reduce, backward identity (closes a
                    row-sharded product, the vocab-cut embedding's
                    partial rows and the vocab-parallel loss's sums:
                    each rank's partial gets the cotangent of the sum)
    tp_open         forward identity, backward all-reduce (opens a
                    tensor-parallel block or the vocab-cut head: the
                    ranks use the replicated input differently, so its
                    gradient is summed once)
    gather_on_use   forward all-gather along a dim, backward this rank's
                    slice of the gradient (every rank computes the
                    gathered layer identically)
    psum_replicas   forward all-reduce, backward the cotangent times n
                    (a sum over data ranks whose gradients the step then
                    averages over the same ranks)
    tp_sum          forward all-reduce, backward all-reduce (a sum that
                    every rank then uses differently: the gated norm's
                    sum of squares over a tensor-parallel mixer's
                    heads)

and, for sequence parallelism (``cfg.seq_shard``: the residual stream
lives cut along the sequence over 'model' between blocks), four more:

    seq_split       forward this rank's slice along a dim, backward
                    all-gather (the residual entering the first block)
    seq_gather      forward all-gather, backward this rank's slice (the
                    residual leaving the last block, and the input of a
                    region every model rank computes alike)
    sp_open         forward all-gather, backward reduce-scatter (the
                    input of a tensor-parallel region: the ranks use the
                    gathered sequence differently, so its gradient is
                    summed once and cut back to the shard)
    sp_close        forward reduce-scatter, backward all-gather (the
                    output of that region, in place of tp_close)

On a single host and in serving (no gradient wanted) ``tp_open`` is the
identity and ``tp_close`` the plain :func:`psum`, so serving's
collectives are unchanged.

Backends: with ``nccl`` every device collective takes CUDA tensors. With
``gloo``, ``all_reduce`` and ``broadcast`` take CUDA tensors themselves
(gloo stages them through host memory inside the call), while its
``all_gather``, ``reduce_scatter``, ``send`` and ``recv`` take CPU
tensors only: for those
the wrappers here copy a CUDA tensor to the host and back, and the
counted seconds include those copies.
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import Mesh

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` this process's mesh (one process is one rank)."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    """This process's mesh, or None off a mesh."""
    return _MESH


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    m = mesh if mesh is not None else _MESH
    if m is None:
        raise RuntimeError(
            "no mesh in this process: collectives need "
            "launch/mesh.py:make_mesh on an initialized world")
    return m


def reset_stats(mesh: Optional[Mesh] = None) -> None:
    m = _mesh(mesh)
    m.stats.clear()


def stats(mesh: Optional[Mesh] = None) -> dict:
    """{kind: operand bytes, ..., "total": bytes, "counts": {kind: n},
    "seconds": {kind: s}} -- ``parse_collective_bytes``'s layout plus the
    seconds."""
    m = _mesh(mesh)
    b = m.stats.get("bytes", {})
    out = {k: int(b.get(k, 0)) for k in KINDS}
    out["total"] = sum(out[k] for k in KINDS)
    out["counts"] = {k: int(m.stats.get("counts", {}).get(k, 0))
                     for k in KINDS}
    out["seconds"] = {k: float(m.stats.get("seconds", {}).get(k, 0.0))
                      for k in KINDS}
    return out


def _count(m: Mesh, kind: str, nbytes: int, t0: float) -> None:
    """One call of ``kind`` moving ``nbytes`` of operand, begun at
    ``t0`` (host clock); a trace mesh's calls take 0 seconds."""
    seconds = 0.0 if m.trace else time.perf_counter() - t0
    for key, val in (("bytes", nbytes), ("counts", 1), ("seconds", seconds)):
        d = m.stats.setdefault(key, {})
        d[kind] = d.get(kind, 0) + val


def _group(m: Mesh, axes):
    names = m.axes_of(axes)
    return (None if m.trace else m.groups[names]), m.group_size(names)


def _host_staged(m: Mesh, x: torch.Tensor) -> bool:
    return x.is_cuda and m.backend == "gloo"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def psum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None,
         op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes`` (a name or a tuple of
    names), in x's dtype, IN PLACE where x is contiguous; every rank of
    the group gets the same bits. ``op`` reduces otherwise (one
    all-reduce all the same)."""
    m = _mesh(mesh)
    group, n = _group(m, axes)
    if n == 1:
        return x
    y = x.contiguous()
    t0 = time.perf_counter()
    if not m.trace:
        dist.all_reduce(y, op=op, group=group)
    _count(m, "all-reduce", _nbytes(y), t0)
    return y


def pmax(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
         ) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes``: ``psum``
    with MAX; no gradient (a caller detaches it first)."""
    return psum(x, axes, mesh, op=dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis, mesh: Optional[Mesh] = None,
               dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in the order of the
    ranks' coordinates on ``axis``."""
    m = _mesh(mesh)
    group, n = _group(m, axis)
    if n == 1:
        return x
    t0 = time.perf_counter()
    if m.trace:
        shape = list(x.shape)
        shape[dim] *= n
        out = x.new_empty(shape)
    else:
        src = x.contiguous()
        work = src.cpu() if _host_staged(m, src) else src
        parts = [torch.empty_like(work) for _ in range(n)]
        dist.all_gather(parts, work, group=group)
        out = torch.cat(parts, dim=dim)
        if out.device != x.device:
            out = out.to(x.device)
    _count(m, "all-gather", _nbytes(x), t0)
    return out


def reduce_scatter(x: torch.Tensor, axis, mesh: Optional[Mesh] = None,
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, cut along ``dim`` into
    as many equal chunks: this rank's chunk, the one at its coordinate on
    ``axis`` (the inverse layout of :func:`all_gather`)."""
    m = _mesh(mesh)
    group, n = _group(m, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks of {axis!r}")
    t0 = time.perf_counter()
    if m.trace:
        shape = list(x.shape)
        shape[dim] //= n
        out = x.new_empty(shape)
    else:
        # The chunks along dim 0 of a contiguous tensor are contiguous.
        src = x.movedim(dim, 0).contiguous()
        work = src.cpu() if _host_staged(m, src) else src
        part = torch.empty((work.shape[0] // n,) + tuple(work.shape[1:]),
                           dtype=work.dtype, device=work.device)
        dist.reduce_scatter(part, list(work.chunk(n)), group=group)
        out = part.movedim(0, dim).to(x.device)
    _count(m, "reduce-scatter", _nbytes(x), t0)
    return out


def broadcast(x: torch.Tensor, src: int = 0, axes=None,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``axes`` (default:
    the whole mesh), IN PLACE; returns x."""
    m = _mesh(mesh)
    group, n = _group(m, axes if axes is not None else m.axes)
    if n == 1:
        return x
    t0 = time.perf_counter()
    if not m.trace:
        # Bytes, whatever the dtype: a broadcast needs no arithmetic.
        buf = x.view(torch.uint8) if x.is_contiguous() and x.dim() else x
        dist.broadcast(buf, src=src, group=group)
    _count(m, "collective-permute", _nbytes(x), t0)
    return x


def send(x: torch.Tensor, dst: int, mesh: Optional[Mesh] = None) -> None:
    """Send ``x`` to global rank ``dst`` (blocking)."""
    m = _mesh(mesh)
    t0 = time.perf_counter()
    if not m.trace:
        src = x.contiguous()
        dist.send(src.cpu() if _host_staged(m, src) else src, dst=dst)
    _count(m, "collective-permute", _nbytes(x), t0)


def recv(x: torch.Tensor, src: int, mesh: Optional[Mesh] = None
         ) -> torch.Tensor:
    """Receive into ``x`` from global rank ``src`` (blocking); returns x."""
    m = _mesh(mesh)
    t0 = time.perf_counter()
    if m.trace:
        pass
    elif _host_staged(m, x):
        buf = torch.empty(x.shape, dtype=x.dtype)
        dist.recv(buf, src=src)
        x.copy_(buf)
    else:
        dist.recv(x, src=src)
    _count(m, "collective-permute", _nbytes(x), t0)
    return x


def broadcast_object(obj: Any, src: int = 0, mesh: Optional[Mesh] = None
                     ) -> Any:
    """A picklable object of rank ``src`` on every rank, over the mesh's
    CPU control group (length, then bytes); counted as collective-permute
    bytes. Only objects this program's ranks sent are unpickled."""
    m = _mesh(mesh)
    t0 = time.perf_counter()
    if m.trace or m.rank == src:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8)
        size = torch.tensor([payload.numel()], dtype=torch.int64)
    else:
        size = torch.zeros(1, dtype=torch.int64)
    if not m.trace:
        dist.broadcast(size, src=src, group=m.control)
        if m.rank != src:
            payload = torch.empty(int(size), dtype=torch.uint8)
        dist.broadcast(payload, src=src, group=m.control)
    _count(m, "collective-permute", int(size) + 8, t0)
    if m.trace or m.rank == src:
        return obj
    return pickle.loads(payload.numpy().tobytes())


def _permute(x: torch.Tensor, axis: str, perm, m: Mesh) -> torch.Tensor:
    """:func:`ppermute`'s exchange, no gradient."""
    (name,) = m.axes_of(axis)
    n = m.shape[name]
    me = m.coord(name)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    if n == 1:
        return x if src is not None else torch.zeros_like(x)
    y = x.contiguous()
    t0 = time.perf_counter()
    out = torch.empty_like(y)
    if m.trace:
        pass
    elif src == me:
        out.copy_(y)
    elif src is not None or dst is not None:
        def peer(c):
            return m.rank_at(**{**m.coords(), name: c})

        staged = _host_staged(m, y)
        buf = torch.empty(y.shape, dtype=y.dtype) if staged else out
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, y.cpu() if staged else y,
                                  peer(dst)))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, buf, peer(src)))
        # Every rank posts its send and its receive at once: a ring in
        # which each rank first blocks in a send would deadlock.
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged and src is not None:
            out.copy_(buf)
    if src is None:
        out.zero_()
    _count(m, "collective-permute", _nbytes(y), t0)
    return out


def ppermute(x: torch.Tensor, axis: str, perm, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """``x`` moved along ``perm``, a list of (source, destination)
    coordinates on ``axis``, within each rank's coordinates on the other
    axes (``jax.lax.ppermute``): the rank at coordinate d gets the x of
    the rank at s for every pair (s, d), zeros where no pair ends at it.
    Its gradient is the cotangent moved along the inverse permutation."""
    m = _mesh(mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    (name,) = m.axes_of(axis)
    n = m.shape[name]
    for ends in (tuple(s for s, _ in perm), tuple(d for _, d in perm)):
        if len(set(ends)) != len(ends) or not all(0 <= c < n for c in ends):
            raise ValueError(f"ppermute: {perm} is not a permutation of "
                             f"coordinates on axis {name!r} of size {n}")
    if not _wants_grad(x):
        return _permute(x, name, perm, m)
    return _Permute.apply(x, name, perm, m)


# ------------------------------------------------------------ autograd
def _size(axes, mesh: Optional[Mesh]) -> int:
    return _mesh(mesh).group_size(axes)


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return psum(x.clone(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.clone(), ctx.axes, ctx.mesh), None, None


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        m = _mesh(mesh)
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.idx = m.coord(axis)
        return all_gather(x, axis, m, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.idx * ctx.size, ctx.size).contiguous(),
                None, None, None)


def _my_slice(x: torch.Tensor, axis: str, dim: int, m: Mesh
              ) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``: the one at its
    coordinate on ``axis`` (a view; no communication)."""
    n = m.group_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks of {axis!r}")
    size = x.shape[dim] // n
    return x.narrow(dim, m.coord(axis) * size, size)


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        m = _mesh(mesh)
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, m
        return _my_slice(x, axis, dim, m).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.axis, ctx.mesh,
                          dim=ctx.dim), None, None, None


class _SpOpen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return all_gather(x, axis, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.mesh, dim=ctx.dim), \
            None, None, None


class _SpClose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return reduce_scatter(y, axis, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.axis, ctx.mesh,
                          dim=ctx.dim), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _permute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute(g, ctx.axis, inverse, ctx.mesh), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return psum(x.clone(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return psum(g.clone(), ctx.axes, ctx.mesh), None, None


class _Replicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.n = _size(axes, mesh)
        return psum(x.clone(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def tp_close(y: torch.Tensor, axes, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """The sum of the ranks' partial ``y`` over ``axes``; its gradient is
    the cotangent itself on every rank. Without a gradient to carry it
    is :func:`psum`."""
    if _size(axes, mesh) == 1:
        return y
    if not _wants_grad(y):
        return psum(y, axes, mesh)
    return _Close.apply(y, axes, mesh)


def tp_open(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
            ) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axes``, once. The
    identity when no gradient is carried (serving)."""
    if _size(axes, mesh) == 1 or not _wants_grad(x):
        return x
    return _Open.apply(x, axes, mesh)


def tp_sum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
           ) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axes``, which every
    rank then uses to scale its own slice of a tensor: its gradient is
    the ranks' cotangents summed. Without a gradient to carry it is
    :func:`psum`."""
    if _size(axes, mesh) == 1:
        return x
    if not _wants_grad(x):
        return psum(x.clone(), axes, mesh)
    return _Sum.apply(x, axes, mesh)


def gather_on_use(x: torch.Tensor, axis: str, dim: int,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The whole leaf from the ranks' slices along ``dim`` over ``axis``;
    its gradient is this rank's slice of the cotangent (every rank
    computes the gathered layer the same way)."""
    if _size(axis, mesh) == 1:
        return x
    if not _wants_grad(x):
        return all_gather(x, axis, mesh, dim=dim)
    return _GatherOnUse.apply(x, axis, dim, mesh)


def seq_split(x: torch.Tensor, axis: str, dim: int,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` over ``axis`` (every rank
    holds the whole ``x`` alike); its gradient is the ranks' gradients
    of their slices gathered, the whole cotangent on every rank."""
    m = _mesh(mesh)
    if m.group_size(axis) == 1:
        return x
    if not _wants_grad(x):
        return _my_slice(x, axis, dim, m).contiguous()
    return _SeqSplit.apply(x, axis, dim, m)


def seq_gather(x: torch.Tensor, axis: str, dim: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim`` over ``axis`` gathered,
    for work every rank then does alike; its gradient is this rank's
    slice of the cotangent (:func:`gather_on_use` on an activation)."""
    return gather_on_use(x, axis, dim, mesh)


def sp_open(x: torch.Tensor, axis: str, dim: int,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim`` gathered, entering a
    tensor-parallel region; its gradient is the ranks' cotangents summed
    and cut back to this rank's slice (a reduce-scatter)."""
    if _size(axis, mesh) == 1:
        return x
    if not _wants_grad(x):
        return all_gather(x, axis, mesh, dim=dim)
    return _SpOpen.apply(x, axis, dim, mesh)


def sp_close(y: torch.Tensor, axis: str, dim: int,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of the ranks' partial ``y`` over ``axis``, this rank's
    slice of it along ``dim`` (a reduce-scatter, closing a
    tensor-parallel region in place of :func:`tp_close`); its gradient
    is the ranks' cotangents gathered."""
    if _size(axis, mesh) == 1:
        return y
    if not _wants_grad(y):
        return reduce_scatter(y, axis, mesh, dim=dim)
    return _SpClose.apply(y, axis, dim, mesh)


def psum_replicas(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
                  ) -> torch.Tensor:
    """The sum of ``x`` over ``axes``; its backward hands each rank n
    times the cotangent, the share that the step's average of the ranks'
    gradients over ``axes`` turns back into one."""
    if _size(axes, mesh) == 1:
        return x
    if not _wants_grad(x):
        return psum(x.clone(), axes, mesh)
    return _Replicas.apply(x, axes, mesh)


def grad_scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x`` whose gradient is scaled by ``s``: a value every rank of an
    axis computes alike, whose gradient a later sum over that axis would
    otherwise count once per rank."""
    if s == 1.0 or not _wants_grad(x):
        return x
    return _Scale.apply(x, s)


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


# ------------------------------------------------------------ roofline
# One NVIDIA H100 80GB HBM3 (SXM5) at its 700.00 W power limit, as
# `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` names
# the card these numbers are for; rates from NVIDIA's H100 Tensor Core
# GPU datasheet (dense, without structured sparsity). A card set below
# 700 W runs slower under load than these.
PEAK_FLOPS = 989.4e12  # dense bf16 FLOP/s per card
HBM_BW = 3.35e12  # HBM3 B/s per card
NVLINK_BW = 25e9  # B/s per NVLink-4 link per direction (18 links a card)


def roofline_terms(
    *, flops: float, hbm_bytes: float, collective_bytes: float,
    chips: int, links_per_chip: int = 1, duplicate_flop_factor: float = 1.0,
) -> Dict[str, float]:
    """Three-term roofline (seconds) of one step, the reference's formula
    on the H100's constants. ``flops``, ``hbm_bytes`` and
    ``collective_bytes`` are one rank's (the dry run traces one rank's
    program); ``chips`` is recorded for reporting only."""
    t_compute = flops / PEAK_FLOPS / duplicate_flop_factor
    t_memory = hbm_bytes / HBM_BW
    t_collective = collective_bytes / (links_per_chip * NVLINK_BW)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_collective), key=lambda kv: kv[1],
    )[0]
    return dict(
        t_compute=t_compute, t_memory=t_memory, t_collective=t_collective,
        dominant=dominant,
        t_bound=max(t_compute, t_memory, t_collective),
    )
