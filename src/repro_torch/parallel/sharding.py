"""Sharding rules: DP/TP/EP/SP specs for every arch family, and the mesh.

Port of ``repro/parallel/sharding.py``. Every rule is a pure function
of leaf names and shapes, as in the reference. A spec is a tuple with
one entry per dim: an axis name, a tuple of axis names, or None
(replicated along that dim); ``()`` is the reference's ``P()``.

Mesh axes: ``pod`` (cross-pod), ``data`` (in-pod DP), ``model`` (TP/EP).
The planner is divisibility-aware per tensor: a dim is sharded on
'model' only when divisible; otherwise that dim stays replicated and
the rest of the network still shards (smollm's 9 heads replicate while
its d_ff=1536 shards 16-way). Param rules match on the parameter's path
leaf name; leading stack axes (the reference's layer scan) are never
sharded, and the port's unstacked layers (``stack/<i>/...``) match the
same rules on their trailing dims.

The serving rules (``serve_*``) are strict: the engine's shard-local
body runs the unchanged model code on 1/tp of the heads and FFN columns
(:func:`serve_local_config`), so a matched dim that does not divide
raises instead of replicating. :func:`shard_params` cuts a full state
dict into one rank's slices by those rules.

Training (:func:`train_shard_params`, :class:`TrainPlan`,
:func:`use_plan`) stores each leaf cut by :func:`param_specs` and runs
the single-host model code on this rank's slices: a block whose stored
slices are exactly its tensor-parallel slices computes them; the Mamba2
mixer runs this rank's heads, reaching the columns they need of its
contiguously cut ``in_proj`` and conv through a gather whose gradient
is summed (``models/ssm.py``); MLA's down-projections multiply by their
stored column slices and gather the latents; the embedding, the head
and the audio heads, stored cut over their vocab, run vocab-parallel
(``models/model.py``: each rank looks up, scores and normalizes over its
own vocab slice, and the loss sums over 'model'); every other sharded
leaf is gathered on use. The reference's ``constrain`` (a hint to
GSPMD) has no counterpart: manual SPMD places every collective itself.

:class:`Mesh` is the port's mesh: an axis -> size map, the row-major
rank grid (rank 0 is every axis' index 0) and, on an initialized
``torch.distributed`` world (``launch/mesh.py:make_mesh``), this rank's
process group for every set of axes. Nothing here touches
``torch.distributed``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig

DATA_AXES = ("pod", "data")  # batch shards over both by default

SERVE_AXES = ("data", "model")  # serving mesh: slot DP x tensor TP
SEQ_AXIS = "model"  # sequence parallelism cuts the residual stream over it

Spec = Tuple[Any, ...]


@dataclasses.dataclass
class Mesh:
    """A named device mesh over ranks.

    ``shape`` maps axis -> size in grid order; ``ranks`` is the rank grid
    (row-major: the last axis varies fastest). ``rank`` is this process's
    rank; ``groups`` maps a tuple of axes (in grid order) to this rank's
    process group over them, and ``control`` is the CPU (gloo) group the
    serving mesh sends its commands on -- all filled by
    ``launch/mesh.py:make_mesh``, empty on a mesh built for specs only;
    ``timeout_s`` is every group's timeout. ``stats`` holds the
    collectives' per-kind counters (``parallel/collectives.py``);
    ``controller`` rank 0's end of a serving mesh's command channel
    (``parallel/worker.py``). ``trace`` marks a mesh built for the dry
    run's trace of one rank's program (``launch/mesh.py:trace_mesh``):
    it has no groups, and every collective on it counts its bytes and
    calls as on a real mesh, returns a tensor of its result's shape and
    moves no data."""

    shape: Dict[str, int]
    rank: int = 0
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)
    control: Any = None
    backend: Optional[str] = None
    timeout_s: float = 60.0
    controller: Any = None
    stats: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    trace: bool = False

    def __post_init__(self) -> None:
        self.shape = {str(a): int(n) for a, n in dict(self.shape).items()}
        if any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes must be >= 1, got {self.shape}")
        self.ranks = np.arange(self.size).reshape(
            tuple(self.shape.values()))

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes_of(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or a tuple of names) in grid order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh {self.shape}")
        return tuple(a for a in self.axes if a in names)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        r = self.rank if rank is None else rank
        idx = np.unravel_index(r, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axes, idx)}

    def coord(self, axis: str, rank: Optional[int] = None) -> int:
        return self.coords(rank)[axis]

    def rank_at(self, **coords: int) -> int:
        """The rank at these axis indices (unnamed axes at 0)."""
        return int(self.ranks[tuple(coords.get(a, 0) for a in self.axes)])

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes_of(axes))


def _mesh_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


def _div(dim: int, mesh: Mesh, axis: str) -> bool:
    return dim % max(1, _mesh_size(mesh, axis)) == 0


# (regex on path-leaf, which trailing dim gets 'model')
# dim index is relative to the LAST ndims of the tensor (negative index).
_PARAM_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    (r"embed$", -2),          # (V, d) or (K, V, d): shard vocab
    (r"heads$", -1),          # audio heads (K, d, V): shard vocab
    (r"head$", -1),           # (d, V)
    (r"wq$|wk$|wv$|wuq$|wuk$|wuv$|wkr$", -1),
    (r"bq$|bk$|bv$", -1),
    (r"wo$", -2),
    (r"w_in$|w_gate$", -1),   # (d, ff) / (E, d, ff)
    (r"w_out$", -2),          # (ff, d) / (E, ff, d)
    (r"router$", None),
    (r"in_proj$", -1),        # ssm (d, d_in_proj)
    (r"out_proj$", -2),       # ssm (d_in, d)
    (r"conv_w$|conv_b$", -1),
    (r"dt_bias$|A_log$|D$", -1),
    (r"scale$", None),        # norms
    (r"wdq$|wdkv$", -1),
)

_EXPERT_LEAF = re.compile(r"(w_in|w_gate|w_out)$")


def _leaf_name(path) -> str:
    """'/'-joined path of a leaf (a path is a tuple of keys, or already a
    name)."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and named
    tuples (cache tuples), keeping its structure. A path is the tuple of
    dict keys, list indices and named-tuple field names down to the
    leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map_with_path(fn, getattr(tree, f),
                                               path + (f,))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_spec(path, leaf, mesh: Mesh) -> Spec:
    """Spec for one parameter (``leaf`` needs ``shape``)."""
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    spec = [None] * ndim
    # Expert tensors (path .../moe/w_*): (..., E, d, ff): shard E on model
    # (EP) when divisible, else fall through to TP on the trailing dim.
    # The 'moe/' requirement keeps layer-stacked dense MLPs (also ndim>=3)
    # on the TP rules.
    if (_EXPERT_LEAF.search(name) and "moe/" in name and "shared" not in name
            and ndim >= 3):
        e_dim = ndim - 3
        if _div(shape[e_dim], mesh, "model"):
            spec[e_dim] = "model"
            return tuple(spec)
    for pat, dim in _PARAM_RULES:
        if re.search(pat, name):
            if dim is None:
                return tuple(spec)
            d = ndim + dim
            if 0 <= d < ndim and _div(shape[d], mesh, "model"):
                spec[d] = "model"
            return tuple(spec)
    return tuple(spec)  # default: replicated


def param_specs(params: Any, mesh: Mesh, profile: str = "tp") -> Any:
    """profile='tp': the rule table above. profile='dp': replicate all
    params and give the batch every mesh axis (models whose per-layer
    GEMMs are too small to shard)."""
    if profile == "dp":
        return tree_map_with_path(
            lambda p, x: (None,) * len(tuple(x.shape)), params)
    return tree_map_with_path(lambda p, x: param_spec(p, x, mesh), params)


# ----------------------------------------------------------- batch / cache
def batch_spec(cfg: ArchConfig, shape, mesh: Mesh, batch: Any,
               profile: str = "tp") -> Any:
    """Specs for the input batch tree: shard the batch dim over (pod,
    data), or over EVERY mesh axis for profile='dp'. ``shape`` is a
    ``ShapeConfig`` (unused, as in the reference)."""

    def one(path, leaf):
        dims = tuple(leaf.shape)
        axes = batch_axes(mesh, dims[0], profile)
        if axes is None:
            return (None,) * len(dims)
        return (axes,) + (None,) * (len(dims) - 1)

    return tree_map_with_path(one, batch)


def batch_axes(mesh: Mesh, rows: int, profile: str = "tp"
               ) -> Optional[Tuple[str, ...]]:
    """The axes :func:`batch_spec` cuts a leaf of ``rows`` batch rows
    over (the mesh's batch axes), or None where the rows do not divide
    over them and the leaf stays replicated."""
    names = DATA_AXES + (("model",) if profile == "dp" else ())
    dp = 1
    for a in names:
        dp *= _mesh_size(mesh, a)
    if rows % dp or rows <= 0:
        return None
    return tuple(a for a in names if a in mesh.shape)


def cache_spec(cfg: ArchConfig, shape, mesh: Mesh, caches: Any) -> Any:
    """KV/SSM cache specs. Caches are stacked over layers (leading axis).

    Batch-shardable -> shard batch dim (axis 1). long_500k (batch 1) ->
    shard the sequence axis of attention caches on 'data' (SP) and the
    head axis of SSM states on 'model'."""
    dp = _mesh_size(mesh, "pod") * _mesh_size(mesh, "data")
    data_axes = tuple(a for a in DATA_AXES if a in mesh.shape)

    def one(path, leaf):
        name = _leaf_name(path)
        dims = tuple(leaf.shape)
        ndim = len(dims)
        spec = [None] * ndim
        if ndim <= 1:  # legacy scalar lengths per layer
            return tuple(spec)
        if name.endswith("length"):  # (layers, B) per-slot lengths
            if shape.global_batch % dp == 0 and dims[-1] == shape.global_batch:
                spec[-1] = data_axes
            return tuple(spec)
        # leading dim(s) are layer stacks; find batch dim = first dim
        # whose size == global batch.
        b_dim = None
        for i, s in enumerate(dims):
            if s == shape.global_batch and i >= 1:
                b_dim = i
                break
        last = name.split("/")[-1]
        if b_dim is not None and shape.global_batch % dp == 0:
            spec[b_dim] = data_axes
            # also TP-shard kv-heads / ssm heads when present
            if last in ("k", "v"):
                if ndim >= b_dim + 3 and _div(dims[b_dim + 2], mesh, "model"):
                    spec[b_dim + 2] = "model"
            if (last == "h" and ndim >= b_dim + 2
                    and _div(dims[b_dim + 1], mesh, "model")):
                spec[b_dim + 1] = "model"
            return tuple(spec)
        # batch too small: SP on the sequence axis (attention caches) or
        # TP on heads (ssm states).
        if name.endswith("/k") or name.endswith("/v"):
            if ndim >= 3 and _div(dims[2], mesh, "data"):
                spec[2] = "data"
            if ndim >= 4 and _div(dims[3], mesh, "model"):
                spec[3] = "model"
            return tuple(spec)
        if name.endswith("/h") and ndim >= 3:
            if _div(dims[2], mesh, "model"):
                spec[2] = "model"
            return tuple(spec)
        return tuple(spec)

    return tree_map_with_path(one, caches)


# ------------------------------------------------------------ SPMD serving
# The serving engine (runtime/server.py) runs its prefill/decode bodies
# on every rank of a (data, model) mesh: slots (and their per-slot
# ``length`` vectors + paged-pool blocks) shard over 'data', attention
# heads / FFN columns over 'model' (Megatron-style: column-shard the
# in-projections, row-shard the out-projections, ONE psum per residual
# write). Skip state is per shard (the paper's per-core SpRF/SASA): every
# data shard keeps its own null block 0 and clamps against its own table
# slice, and the summed skip counters are the aggregated telemetry.

# Column-sharded over 'model' on the trailing dim: all Q/K/V in-projections
# (head-major column layout, so a 1/tp column slice IS a head slice), the
# MLA up-projections, and both GLU in-projections.
_SERVE_COL = re.compile(r"(wq|wk|wv|bq|bk|bv|wuq|wuk|wuv|w_in|w_gate)$")
# Row-sharded (dim -2): the out-projections whose contraction dim is the
# sharded one -- their product is a partial sum, closed by one psum.
_SERVE_ROW = re.compile(r"(wo|w_out)$")


def serve_local_config(cfg: ArchConfig, tp: int) -> ArchConfig:
    """The per-shard view of ``cfg`` the shard-local body runs unchanged:
    1/tp of the heads, kv heads and FFN columns, with ``tp_axis`` set so
    attention/MLP close their row-sharded out-projections with a psum.
    The head dim is pinned to the whole model's: a config that leaves it
    to ``d_model // num_heads`` (smollm-135m's) would otherwise get tp
    times wider heads on a shard (the reference's rule does not pin it,
    and its full-width configs with an unset head dim cannot run there
    for that reason; its reduced configs set the head dim)."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide num_heads="
            f"{cfg.num_heads}, num_kv_heads={cfg.num_kv_heads} and "
            f"d_ff={cfg.d_ff}")
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff // tp,
        tp_axis="model",
    )


def serve_param_spec(path, leaf, mesh: Mesh) -> Spec:
    """Serving-TP spec for one parameter (strict: a matched dim that does
    not divide raises instead of silently replicating, because the
    shard-local config assumes exact 1/tp slices)."""
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    tp = _mesh_size(mesh, "model")
    for pat, dim in ((_SERVE_COL, -1), (_SERVE_ROW, -2)):
        if pat.search(name):
            d = ndim + dim
            if shape[d] % tp:
                raise ValueError(
                    f"serving TP: param {name!r} dim {dim} "
                    f"({shape[d]}) does not divide over "
                    f"{tp} model shards")
            spec = [None] * ndim
            spec[d] = "model"
            return tuple(spec)
    # Everything else (embed/head, norms, MLA down-projections wdq/wdkv/
    # wkr) is replicated: decode-time logits and the latent KV cache must
    # be whole on every shard.
    return (None,) * ndim


def serve_param_specs(params: Any, mesh: Mesh) -> Any:
    return tree_map_with_path(
        lambda p, x: serve_param_spec(p, x, mesh), params)


def serve_paged_cache_specs(cfg: ArchConfig) -> Any:
    """Spec tree matching the paged caches of ``model.init_paged_caches``
    for the serving pool: blocks shard over 'data' (each data shard owns
    its own sub-pool INCLUDING its own null block 0), KV heads over
    'model' (GQA; the MLA latent/rope pools are 'model'-replicated since
    wdkv/wkr are), and the per-slot ``length`` vector over 'data'."""
    from repro_torch.models.attention import PagedKVCache  # noqa: PLC0415

    if cfg.mla is not None:
        kv = (None, "data", None, None)  # (L, blocks, bs, lat/rope)
    else:
        kv = (None, "data", None, "model", None)  # (L, nb, bs, KV, hd)
    return {"stack": PagedKVCache(kv, kv, (None, "data"))}


def serve_prefill_cache_specs(cfg: ArchConfig) -> Any:
    """Spec tree for the batch=1 contiguous scratch caches a prefill body
    returns: KV heads over 'model' (GQA), everything else replicated."""
    from repro_torch.models.attention import KVCache  # noqa: PLC0415

    if cfg.mla is not None:
        kv = ()
    else:
        kv = (None, None, None, "model", None)  # (L, 1, S, KV, hd)
    return {"stack": KVCache(kv, kv, ())}


def block_index(spec: Spec, mesh: Mesh, rank: int
                ) -> Tuple[Tuple[int, int, int], ...]:
    """Where rank ``rank``'s block lies under ``spec``: (dim, chunk
    index, chunks) for each dim cut over more than one rank, the chunk
    index the rank's (row-major) coordinate over the dim's axes. Ranks
    with the same index hold the same block."""
    coords = mesh.coords(rank)
    out = []
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        n, idx = 1, 0
        for a in mesh.axes_of(axes):
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if n > 1:
            out.append((d, idx, n))
    return tuple(out)


def shard_of(x, spec: Spec, mesh: Mesh, rank: int):
    """Rank ``rank``'s block of tensor ``x`` under ``spec``: every dim
    named by axes is cut into equal contiguous chunks, chunk index the
    rank's (row-major) coordinate over those axes; a contiguous copy."""
    out = x
    for d, idx, n in block_index(spec, mesh, rank):
        size = x.shape[d]
        if size % n:
            raise ValueError(f"dim {d} ({size}) does not divide over {n} "
                             f"shards {mesh.axes_of(spec[d])}")
        step = size // n
        out = out.narrow(d, idx * step, step)
    return out.contiguous()


def shard_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` under
    ``spec`` (see :func:`shard_of`)."""
    out = list(shape)
    for d, axes in enumerate(spec):
        if axes is not None:
            out[d] //= mesh.group_size(axes)
    return tuple(out)


def shard_params(params: Any, mesh: Mesh, rank: Optional[int] = None) -> Any:
    """The full state dict ``params`` cut to rank ``rank``'s slices by
    :func:`serve_param_specs` (default: the mesh's own rank); each leaf
    contiguous. Raises where a matched dim does not divide."""
    r = mesh.rank if rank is None else rank
    return tree_map_with_path(
        lambda p, x: shard_of(x, serve_param_spec(p, x, mesh), mesh, r),
        params)



# ---------------------------------------------------------------- training
def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis name a spec shards over, in dim order."""
    out = []
    for a in spec:
        if a is None:
            continue
        out.extend((a,) if isinstance(a, str) else a)
    return tuple(out)


def train_shard_params(params: Any, mesh: Mesh,
                       rank: Optional[int] = None) -> Any:
    """The full tree ``params`` cut to rank ``rank``'s slices by
    :func:`param_specs` (default: the mesh's own rank): a dim that does
    not divide stays whole, as the spec says. Returns (slices, specs)."""
    specs = param_specs(params, mesh)
    r = mesh.rank if rank is None else rank
    return cut_tree(params, specs, mesh, r), specs


def cut_tree(tree, specs, mesh: Mesh, rank: int):
    """Every leaf of ``tree`` cut to rank ``rank``'s block under its spec
    in ``specs`` (a spec tree of the same structure)."""
    if isinstance(tree, dict):
        return {k: cut_tree(tree[k], specs[k], mesh, rank) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [cut_tree(v, s, mesh, rank) for v, s in zip(tree, specs)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return shard_of(tree, specs, mesh, rank)


_AMBIENT: Dict[str, Any] = {"plan": None}


@contextlib.contextmanager
def use_plan(plan: Optional["TrainPlan"]) -> Iterator[Optional["TrainPlan"]]:
    """The ambient mesh of a sharded training step (the reference's
    ``with mesh:``): ``plan`` and its mesh, for the code run inside. A
    process-wide setting, not a thread's: the backward (and a
    recomputation under remat) may run on autograd's device thread."""
    before = _AMBIENT["plan"]
    _AMBIENT["plan"] = plan
    try:
        yield plan
    finally:
        _AMBIENT["plan"] = before


def current_plan() -> Optional["TrainPlan"]:
    """The ambient sharded-training plan (its ``mesh`` the ambient mesh,
    the reference's ``current_mesh()``), or None."""
    return _AMBIENT["plan"]


class TrainPlan:
    """How this rank runs one sharded training step.

    ``specs`` is the :func:`param_specs` tree of the full params and
    ``params`` this rank's slices of them (the same structure); the plan
    keys each stored slice by identity for the step. ``batch_axes`` are
    the axes the batch rows were cut over (empty when the batch stays
    replicated). The 'model' axis is tensor- and expert-parallel.

    A block is tensor-parallel where its stored slices are its TP
    slices: GQA when the heads and KV heads divide by the model size,
    MLA when the heads do (its down-projections multiply by their stored
    column slices, the latents then gathered whole), the MLP when
    ``d_ff`` does, the Mamba2 mixer when its heads do
    (:meth:`mixer_tp`), and the embedding, head and audio heads when
    the vocab does (:meth:`vocab_tp`). Every other sharded leaf is
    gathered on use (``collectives.gather_on_use``).

    Sequence parallelism (:meth:`seq_parallel`) cuts the residual stream
    along the sequence over 'model' between blocks. ``cache_rows`` are
    the axes the contiguous attention caches' rows are cut over (the
    long-context decode layout of :func:`cache_spec`; empty: every rank
    holds every row), which a decode step then merges over."""

    def __init__(self, mesh: Mesh, cfg: ArchConfig, specs: Any, params: Any,
                 batch_axes: Optional[Tuple[str, ...]] = None,
                 cache_rows: Tuple[str, ...] = ()):
        from repro_torch.models.modules import iter_leaves  # noqa: PLC0415

        self.mesh, self.cfg = mesh, cfg
        self.batch_cut = batch_axes is not None
        self.batch_axes = tuple(a for a in mesh.axes
                                if a in (batch_axes or ()))
        self.cache_rows = tuple(a for a in mesh.axes if a in cache_rows
                                and mesh.shape[a] > 1)
        self._spec = {id(t): s for t, s in zip(iter_leaves(params),
                                               iter_leaves_specs(specs))}
        # No leaf cut over 'model' (the 'dp' profile): every param is
        # whole and no block is tensor-parallel.
        cut = any("model" in spec_axes(s) for s in self._spec.values())
        self.model = _mesh_size(mesh, "model") if cut else 1

    # ----------------------------------------------------------- sizes
    @property
    def batch_size(self) -> int:
        """Ranks the batch rows are cut over."""
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    def attn_tp(self, cfg: ArchConfig) -> bool:
        M = self.model
        if M == 1:
            return False
        if cfg.mla is not None:
            return cfg.num_heads % M == 0
        return cfg.num_heads % M == 0 and cfg.num_kv_heads % M == 0

    def mlp_tp(self, cfg: ArchConfig) -> bool:
        return self.model > 1 and cfg.d_ff % self.model == 0

    def mixer_tp(self, cfg: ArchConfig) -> bool:
        """Whether the Mamba2 mixer runs this rank's heads: the model
        size M > 1 divides the heads, each rank's heads read whole B/C
        groups (M divides the groups, or the groups divide M), and
        ``in_proj`` and the conv are stored cut (M divides their
        columns). Else the mixer is gathered whole."""
        M = self.model
        if M == 1 or cfg.ssm is None:
            return False
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        heads, G = d_in // s.head_dim, s.ngroups
        conv = d_in + 2 * G * s.d_state
        return (heads % M == 0 and (G % M == 0 or M % G == 0)
                and (conv + d_in + heads) % M == 0 and conv % M == 0)

    def mixer_heads(self, cfg: ArchConfig) -> Tuple[int, int]:
        """(first head, heads) this rank's tensor-parallel mixer runs:
        the r-th of M equal runs of the heads, r its 'model' index."""
        s = cfg.ssm
        H = s.expand * cfg.d_model // s.head_dim // self.model
        return self.mesh.coord("model") * H, H

    def vocab_tp(self, cfg: ArchConfig) -> bool:
        """Whether the embedding, the head and the audio heads run on
        this rank's vocab slice: the model size M > 1 divides the vocab,
        the rule by which :func:`param_spec` stores them cut. Else they
        are stored whole and read whole."""
        return self.model > 1 and cfg.vocab_size % self.model == 0

    def vocab_first(self, cfg: ArchConfig) -> int:
        """The first id of this rank's vocab slice under :meth:`vocab_tp`:
        the slice is the r-th of M equal runs of the vocab, r this rank's
        'model' index."""
        return self.mesh.coord("model") * (cfg.vocab_size // self.model)

    def seq_parallel(self, cfg: ArchConfig, seq: int) -> bool:
        """Whether the residual stream of a ``seq``-long sequence lives
        cut along the sequence over 'model' between blocks: the
        reference's ``seq_shard`` constraint, under a plan whose model
        axis (> 1) runs tensor-parallel, for a sequence longer than one
        token (a decode step keeps it whole). Raises where the sequence
        does not divide (the reference's GSPMD pads there)."""
        M = self.model
        if not cfg.seq_shard or M == 1 or seq <= 1:
            return False
        if seq % M:
            raise ValueError(
                f"seq_shard: a sequence of {seq} tokens does not divide "
                f"over the {M} ranks of 'model'")
        return True

    def moe_groups(self, cfg: ArchConfig) -> Tuple[str, int]:
        """("ep", M): experts split over 'model', each rank routing its
        batch shard's tokens to its own experts (the reference's
        ``_moe_forward_ep``, legal when M > 1 divides the experts and
        the batch was cut over the data axes); ("local", 1): every
        expert on every rank, tokens routed per batch shard (the experts
        do not divide); ("global", 1): the batch is whole on every rank,
        the global path."""
        if not self.batch_cut:
            return "global", 1
        M = self.model
        if M > 1 and cfg.moe.num_experts % M == 0:
            return "ep", M
        return "local", 1

    # ----------------------------------------------------------- views
    def spec(self, t) -> Spec:
        return self._spec.get(id(t), (None,) * t.dim())

    def gather(self, t):
        """The whole leaf ``t`` (its 'model' slices gathered on use)."""
        from repro_torch.parallel import collectives  # noqa: PLC0415

        for d, a in enumerate(self.spec(t)):
            if a is None:
                continue
            for axis in ((a,) if isinstance(a, str) else a):
                if self.mesh.shape.get(axis, 1) > 1:
                    t = collectives.gather_on_use(t, axis, d, self.mesh)
        return t

    def gather_tree(self, tree):
        if isinstance(tree, dict):
            return {k: self.gather_tree(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather_tree(v) for v in tree)
        return self.gather(tree)

    def top(self, params: dict, cfg: ArchConfig) -> dict:
        """The top-level leaves the forward reads outside the stacks
        (embed, head, heads): this rank's vocab slices as stored where
        they run vocab-parallel (:meth:`vocab_tp`), else gathered (a
        leaf stored whole passes unchanged); the stacks as they are."""
        out = dict(params)
        if self.vocab_tp(cfg):
            return out
        for k in ("embed", "head", "heads"):
            if k in out:
                out[k] = self.gather_tree(out[k])
        return out

    def block(self, params: dict, cfg: ArchConfig, kind: str):
        """(params, cfg, MLP tp axis) a block runs on this rank: the
        block's config cut to its TP slice where it is tensor-parallel
        (``tp_axis`` set), its other sharded leaves gathered."""
        out = dict(params)
        if kind == "ssm":
            if self.mixer_tp(cfg):
                return out, dataclasses.replace(cfg, tp_axis="model"), None
            out["mixer"] = self.gather_tree(params["mixer"])
            return out, dataclasses.replace(cfg, tp_axis=None), None
        if self.attn_tp(cfg):
            M = self.model
            if cfg.mla is not None:
                lcfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // M,
                                           tp_axis="model")
            else:
                lcfg = dataclasses.replace(
                    cfg, num_heads=cfg.num_heads // M,
                    num_kv_heads=cfg.num_kv_heads // M,
                    head_dim=cfg.resolved_head_dim, tp_axis="model")
        else:
            out["attn"] = self.gather_tree(params["attn"])
            lcfg = dataclasses.replace(cfg, tp_axis=None)
        if kind == "moe":
            if self.moe_groups(cfg)[0] != "ep":
                out["moe"] = self.gather_tree(params["moe"])
            return out, lcfg, None
        if self.mlp_tp(cfg):
            return out, lcfg, "model"
        out["mlp"] = self.gather_tree(params["mlp"])
        return out, lcfg, None


def iter_leaves_specs(specs) -> Iterator[Spec]:
    """The specs of a spec tree in ``iter_leaves`` order (a spec is a
    tuple: a leaf here, not a branch)."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from iter_leaves_specs(specs[k])
    elif isinstance(specs, list) or (isinstance(specs, tuple)
                                     and hasattr(specs, "_fields")):
        for v in specs:
            yield from iter_leaves_specs(v)
    else:
        yield specs
