"""Continuous-batching serving engine over the paged KV pool or the
contiguous KV layout, with live admission, preemption, cancellation and
fault containment.

Port of the single-host engine of ``repro/runtime/server.py``. One
``step()`` is:

  0. **cancellations** -- uids marked by :meth:`Server.cancel` (from any
     thread) are collected: queued entries are purged, live slots are
     evicted with their blocks released.
  1. **admission** -- while a slot is free and the queue head's
     worst-case KV-block commitment fits the pool
     (:meth:`BlockAllocator.try_reserve`), the
     :class:`~repro_torch.runtime.scheduler.Scheduler` decides whether
     to spend the gap on a prefill or defer to the decode tick
     (``ServeConfig.slo``; greedy without one). An admitted head
     prefills alone (batch=1, prompt padded up to a power-of-two bucket,
     logits taken at the last REAL position; the moe family, whose
     capacity routing depends on the batch shape, at exact length) and
     scatters its rows into pool blocks; its first token comes from the
     prefill logits. With ``ServeConfig.preempt`` a TTFT-forced head
     that finds no slot, or no blocks, may evict one lower-priority
     victim (requeued with its tokens as resume state; its restore
     prefill runs prompt ++ produced). A request-scoped fault in a
     head's prefill (an injected poison, a prompt-shaped ``ValueError``)
     fails that request only: its blocks and commitment roll back.
  2. **decode tick** -- injected step faults first, then lazy block
     growth (through the fault injector's allocator gate with bounded
     retries), then one :func:`model.serving_decode_step` for all slots
     with the live-slot mask. Dead slots' embeddings are zeroed, so
     their MLP gate tiles are all-zero (dead) tiles; with
     ``attn_kernel="paged"`` their KV blocks, and every block past each
     live length, are never read.
  3. **release** -- a slot frees the moment its request hits EOS or its
     ``max_new`` budget (or fails its ``max_ticks`` deadline): blocks
     return to the pool, the unused commitment is un-reserved, and the
     ledger is re-checked.

Three front doors drive that step: :meth:`Server.generate` (a fixed
list, drained), :meth:`Server.serve_trace` (an open-loop arrival trace
on the virtual clock, with priorities and TTFT deadlines) and
:class:`AsyncServer` (a background engine thread fed by client threads
through :meth:`AsyncServer.submit`). Every scheduling decision runs on
the reference's deterministic virtual tick clock (``core/cost_model.py``:
modeled costs, not measurements), so on the same trace, weights and
fault plan the port admits, preempts, sheds, fails and releases in the
reference's order and reports the same integer and skip metrics; wall
clock times are reported beside them and never consulted.

Prefix-cache block sharing (``ServeConfig.prefix_cache``, the dense
family): after every prefill the prompt's FULL blocks are chain-hashed
into a :class:`~repro_torch.runtime.paging.PrefixCache`; a later
admission whose prompt shares a cached prefix maps those pool blocks
into its table READ-ONLY (one allocator reference each; the shared run
first, owned blocks after it, so decode writes never reach them),
prefills only the bucketed suffix (``_prefill_suffix``: the prefix
gathered from the pool, the suffix run with ``continuation=True``), and
on a full-prompt match forks the last block copy-on-write, since the
last prompt row must re-run for its logits. A preempted victim's written
full blocks are registered too, so its restore is suffix-only while they
survive.

The contiguous layout (``kv_block_size=0``, and always for the ssm and
hybrid families, whose recurrent states have no per-token rows to page)
keeps one ``max_len``-row cache per slot: admission prefills into a
batch=1 scratch of the same row count and overwrites the slot's row of
every cache leaf (:func:`model.insert_slot_caches`); there is no pool,
so no block growth, no prefix sharing and no preemption, and the paged
decode kernel is refused, as the reference refuses them.

The vlm frontend puts ``num_patches`` patch rows (zero embeddings, the
frontend's stand-in) ahead of every prompt, and they count in every row
and block count; the audio frontend's prompts are (K, S) codebook
streams, its decode tokens (B, K, 1), and a request stops at EOS only
when every codebook samples it.

The (data, model) serving mesh (``ServeConfig.mesh = (dp, tp)``, the
paged layout of a bucketable family): slots, their lengths and their
pool blocks shard over 'data' (slot ``s`` lives on data shard ``s //
(batch_slots / dp)``), attention heads and FFN columns over 'model'.
Every data shard keeps its own null block 0, its own
:class:`~repro_torch.runtime.paging.BlockAllocator` and its own prefix
index (``st.allocs``, ``_prefixes``; ``st.alloc`` and ``_prefix`` are
shard 0's), so block ids in the tables are shard-local, a prefix only
matches blocks of its own shard, and reclaim for block pressure evicts a
victim of the head's shard. One controller: this ``Server`` runs on rank
0 of a mesh started by ``launch/mesh.py:spawn_mesh`` and holds all host
state; its device actions are commands the other ranks run on their
shards (``parallel/worker.py``). The skip counters are summed over the
shards, so ``ServeMetrics`` equal the single-host engine's.

Threads: ``Server`` is single-threaded -- one thread calls
``start_engine``/``step``/``generate``/``serve_trace``; ``enqueue`` and
``cancel`` are safe from any thread. ``AsyncServer`` runs all engine work
(every kernel launch) on its one background thread, on that thread's
current CUDA stream; only numpy arrays and host scalars cross to client
threads.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as _queue_mod
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cost_model, sasa
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_decode_attn import decode_attn_block_counts
from repro_torch.models import model as model_lib
from repro_torch.parallel.sharding import serve_local_config
from repro_torch.parallel.worker import ShardEngine
from repro_torch.runtime.errors import (
    EngineFatal, RequestCancelled, RequestFailed, ServerOverloaded,
    ServingError, is_request_scoped,
)
from repro_torch.runtime.faults import FaultInjector, FaultPlan, InjectedFault
from repro_torch.runtime.metrics import ServeMetrics
from repro_torch.runtime.paging import (
    BlockAllocator, PrefixCache, blocks_needed, pick_bucket, resolve_buckets,
)
from repro_torch.runtime.queueing import QueuedRequest, RequestQueue
from repro_torch.runtime.scheduler import Scheduler, SLOConfig

# Lazy block-growth alloc attempts per growth event: attempt 0 plus this
# many retries. A transient alloc fault clearing within the bound
# recovers in place (faults_recovered); anything past it fails the ONE
# request whose growth it was (request-scoped, never engine-fatal).
_GROW_RETRIES = 3


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,)
    max_new: int = 32
    eos_id: Optional[int] = None  # overrides ServeConfig.eos_id
    # Per-request decode deadline: cancel after this many decode ticks
    # of progress (across preemptions) even if max_new was not reached.
    # The partial output lands on ``out``; waiters see RequestCancelled.
    max_ticks: Optional[int] = None
    out: Optional[np.ndarray] = None
    # Set when the request failed (RequestCancelled / RequestFailed /
    # ServerOverloaded); ``out`` then holds the tokens produced before.
    error: Optional[BaseException] = None
    # Preemption state: every token produced before the last preemption
    # (set on requeue). The restore prefills prompt ++ resume_tokens.
    resume_tokens: Optional[List[np.ndarray]] = None
    # Filled by the engine: ttft_s, latency_s, tokens, decode_ticks,
    # queue_ticks, ttft_ticks, itl_ticks_max (+ preemptions when > 0).
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServeConfig:
    """Engine configuration; the reference's fields, validated at
    construction. Fields whose engine paths are not ported yet are kept
    for API parity and rejected when set."""

    batch_slots: int = 8
    max_len: int = 512
    temperature: float = 0.0  # 0 => greedy
    eos_id: Optional[int] = None
    seed: int = 0
    # Replaces cfg.sparsity for prefill + decode when set.
    sparsity: Optional[SparsityConfig] = None
    kv_block_size: int = 16  # rows per KV pool block
    kv_pool_blocks: Optional[int] = None  # None = worst-case pool
    # None = powers of two up to max_len; () = exact-length prefill.
    prefill_buckets: Optional[Tuple[int, ...]] = None
    # 'gather' = full per-slot pool view; 'paged' = the paged kernel.
    attn_kernel: str = "gather"
    prefix_cache: bool = False
    mesh: Optional[Tuple[int, int]] = None
    # Latency SLO for admission; None = drain mode (greedy admission).
    slo: Optional[SLOConfig] = None
    # Bounded admission queue: pushes past it are shed with
    # ServerOverloaded. None = unbounded.
    max_queue_depth: Optional[int] = None
    # Let a TTFT-forced head evict a lower-priority slot (requeued for a
    # restore prefill). Needs the paged layout.
    preempt: bool = False
    # Seeded fault-injection plan; None = no injection (containment is
    # live either way).
    faults: Optional[FaultPlan] = None

    def __post_init__(self) -> None:
        if self.batch_slots < 1:
            raise ValueError(
                f"ServeConfig.batch_slots must be >= 1, got "
                f"{self.batch_slots}")
        if self.max_len < 1:
            raise ValueError(
                f"ServeConfig.max_len must be >= 1, got {self.max_len}")
        if self.kv_block_size < 0:
            raise ValueError(
                f"ServeConfig.kv_block_size must be >= 0, got "
                f"{self.kv_block_size}")
        if self.kv_pool_blocks is not None and self.kv_pool_blocks < 1:
            raise ValueError(
                f"ServeConfig.kv_pool_blocks must be >= 1 (or None for "
                f"the worst-case pool), got {self.kv_pool_blocks}")
        if self.attn_kernel not in ("gather", "paged"):
            raise ValueError(
                f"ServeConfig.attn_kernel must be 'gather' or 'paged', "
                f"got {self.attn_kernel!r}")
        if self.attn_kernel == "paged" and self.kv_block_size <= 0:
            raise ValueError(
                "ServeConfig.attn_kernel='paged' needs the paged KV "
                "layout: set kv_block_size > 0")
        if self.prefix_cache and self.kv_block_size <= 0:
            raise ValueError(
                "ServeConfig.prefix_cache=True needs the paged KV "
                "layout: shared prefixes are pool blocks mapped into "
                "several tables, so set kv_block_size > 0")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"ServeConfig.max_queue_depth must be >= 1 (or None "
                f"for unbounded), got {self.max_queue_depth}")
        if self.preempt and self.kv_block_size <= 0:
            raise ValueError(
                "ServeConfig.preempt=True needs the paged KV layout "
                "(reclaim returns pool BLOCKS): set kv_block_size > 0")
        if self.mesh is not None:
            dp, tp = self.mesh
            if dp < 1 or tp < 1:
                raise ValueError(
                    f"ServeConfig.mesh axes must be >= 1, got {self.mesh}")
            if self.kv_block_size <= 0:
                raise ValueError(
                    "ServeConfig.mesh needs the paged KV layout (the "
                    "pool blocks are what shards over 'data'): set "
                    "kv_block_size > 0")
            if self.batch_slots % dp:
                raise ValueError(
                    f"ServeConfig.mesh data axis {dp} must divide "
                    f"batch_slots={self.batch_slots} (slots shard "
                    "contiguously over 'data')")


@dataclasses.dataclass
class _Slot:
    req: Request
    item: QueuedRequest
    produced: List[np.ndarray]
    t_admit: float
    t_first: float
    ticks: int = 0
    cache_len: int = 0  # rows currently in this slot's cache
    blocks: List[int] = dataclasses.field(default_factory=list)
    # Prefix-cache blocks mapped READ-ONLY into this slot's table (one
    # allocator reference each, released with the slot); they sit before
    # ``blocks`` in the table, so decode writes never touch them.
    shared: List[int] = dataclasses.field(default_factory=list)
    commit: int = 0  # worst-case pool blocks promised to this request
    admit_vt: float = 0.0
    first_vt: float = 0.0
    last_token_vt: float = 0.0
    itl_max: float = 0.0
    released: bool = False


@dataclasses.dataclass
class _EngineState:
    # The device side (this rank's caches live on it).
    engine: ShardEngine
    # One allocator per data shard (shard-local block ids; one on a
    # single host) and the block tables; ``alloc`` is shard 0's. None
    # and [] in the contiguous layout.
    alloc: Optional[BlockAllocator]
    tables: Optional[np.ndarray]
    slots: List[Optional[_Slot]]
    cur_tok: np.ndarray
    completed: List[Request]
    # Requests that FAILED (cancelled / request-scoped fault); like
    # ``completed``, kept only for sync drivers (an on_error consumer
    # takes them instead).
    failed: List[Request] = dataclasses.field(default_factory=list)
    allocs: List[BlockAllocator] = dataclasses.field(default_factory=list)

    @property
    def caches(self):
        """This rank's KV caches (its sub-pool on a mesh)."""
        return self.engine.caches


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


class Server:
    """Fixed-slot continuous batcher over the paged KV pool (or the
    contiguous layout: ``kv_block_size=0``, and the ssm and hybrid
    families whatever the block size).

    ``device`` defaults to ``"cuda"`` and raises on a host without a GPU
    unless ``device="cpu"`` is passed; ``params`` must live on it.
    """

    def __init__(self, cfg: ArchConfig, params, serve_cfg: ServeConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        if serve_cfg.sparsity is not None:
            cfg = dataclasses.replace(cfg, sparsity=serve_cfg.sparsity)
        self.cfg, self.params, self.sc = cfg, params, serve_cfg
        # The ssm and hybrid families fall back to the contiguous layout
        # whatever the block size.
        self._paged = (serve_cfg.kv_block_size > 0
                       and cfg.family in model_lib.paged_families())
        # Value checks of the family (no params touched), the reference's.
        model_lib.check_family(cfg)
        if serve_cfg.attn_kernel == "paged" and not self._paged:
            raise ValueError(
                "attn_kernel='paged' needs the paged KV layout (set "
                "kv_block_size > 0; ssm/hybrid families fall back to "
                "contiguous caches and must keep attn_kernel='gather')")
        # Prompt rows share the cache with the (constant) patch prefix.
        self._patch_rows = (cfg.num_patches if cfg.frontend == "patches"
                            else 0)
        if serve_cfg.prefix_cache:
            if not self._paged:
                raise ValueError(
                    "prefix_cache=True needs the paged KV layout (set "
                    "kv_block_size > 0; ssm/hybrid families have no "
                    "per-token rows to share)")
            if (cfg.family not in model_lib.bucketable_families()
                    or self._patch_rows):
                raise ValueError(
                    f"prefix_cache=True is not supported for family "
                    f"{cfg.family!r}: suffix-only prefill needs bucketed "
                    "(masked-tail) prefill to be exact and a token-only "
                    "cache prefix (patch rows are per-request)")
        if serve_cfg.preempt and not self._paged:
            raise ValueError(
                "preempt=True needs the paged KV layout (set "
                "kv_block_size > 0; ssm/hybrid families fall back to "
                "contiguous caches, which have no blocks to reclaim)")
        if model_lib.params_device(params).type != self.device.type:
            raise ValueError(
                f"params live on {model_lib.params_device(params)}, the "
                f"server runs on {self.device}")
        self._max_rows = serve_cfg.max_len + self._patch_rows
        if self._paged:
            self._max_blocks = blocks_needed(self._max_rows,
                                             serve_cfg.kv_block_size)
            self._pool_usable = (
                serve_cfg.kv_pool_blocks
                if serve_cfg.kv_pool_blocks is not None
                else serve_cfg.batch_slots * self._max_blocks)
        else:
            self._max_blocks = 0
            self._pool_usable = 0
        # Padded (bucketed) prefill is exact only for bucketable
        # families; the rest (moe) prefill at exact length.
        self._buckets = (
            resolve_buckets(serve_cfg.prefill_buckets, serve_cfg.max_len)
            if cfg.family in model_lib.bucketable_families() else ())
        # Suffix-prefill scratch rows: a bucketed suffix behind a
        # near-full prefix reaches prefix + bucket rows, so the scratch is
        # oversized by the largest bucket (rows past the table land in
        # the null block on insert).
        self._ext_rows = self._max_rows + (
            max(self._buckets) if self._buckets else self._max_rows)
        # The (data, model) mesh: slots shard over 'data' (b_local each,
        # contiguous), every data shard owns pool_shard usable blocks plus
        # its own null block 0. A single host is the one-shard case.
        self._mesh = None
        self._dp = self._tp = 1
        self._b_local = serve_cfg.batch_slots
        self._pool_shard = self._pool_usable
        layout = dict(paged=self._paged, pool_blocks=self._pool_usable,
                      max_rows=self._max_rows, ext_rows=self._ext_rows)
        if serve_cfg.mesh is not None:
            self._engine = self._init_mesh(layout)
        else:
            self._engine = ShardEngine(cfg, params, serve_cfg, self.device,
                                       **layout)
        self._ema = sasa.SparsityEMA()
        self._rng = np.random.default_rng(serve_cfg.seed)
        # Distinct prefill shapes served: the port runs eagerly, so this
        # is its counterpart of the reference's prefill trace count.
        self._prefill_shapes: set = set()
        self._costs = cost_model.serve_tick_costs(cfg, serve_cfg.batch_slots)
        self._sched = Scheduler(self._costs, serve_cfg.slo,
                                max_queue_depth=serve_cfg.max_queue_depth)
        self._queue = RequestQueue(max_depth=serve_cfg.max_queue_depth)
        # Cross-thread cancellation: uids marked here are collected by
        # the engine thread at its next step boundary.
        self._cancel_lock = threading.Lock()
        self._cancel_pending: set = set()
        # Fault injector of the CURRENT run (rebuilt per start_engine, so
        # a rerun of the same plan injects the same faults).
        self._inj: Optional[FaultInjector] = None
        self._inj_seen = 0  # injector events already folded into metrics
        self._vt = 0.0
        self._vt_prefill = 0.0
        self._vt_decode = 0.0
        self._ttft_ticks_all: deque = deque(maxlen=100_000)
        self._ttft_s_all: deque = deque(maxlen=100_000)
        self._itl_ticks_all: deque = deque(maxlen=500_000)
        self.admitted_uids: deque = deque(maxlen=100_000)
        self._st: Optional[_EngineState] = None
        # The run's prefix indexes, one per data shard (built in
        # start_engine when enabled); ``_prefix`` is shard 0's.
        self._prefix: Optional[PrefixCache] = None
        self._prefixes: Optional[List[PrefixCache]] = None
        # AsyncServer's hooks, called on the engine thread. on_error fires
        # for a request that FAILS instead of finishing, after its
        # resources were released.
        self.on_token: Optional[Callable[[Request, np.ndarray], None]] = None
        self.on_finish: Optional[Callable[[Request], None]] = None
        self.on_error: Optional[
            Callable[[Request, BaseException], None]] = None
        self.metrics = ServeMetrics(
            kv_paged=float(self._paged),
            kv_block_size=float(
                serve_cfg.kv_block_size if self._paged else 0),
            kv_pool_blocks=float(self._pool_usable),
            attn_kernel_paged=float(serve_cfg.attn_kernel == "paged"),
            prefix_cache_enabled=float(serve_cfg.prefix_cache),
            mesh_data=float(self._dp if self._mesh is not None else 0),
            mesh_model=float(self._tp if self._mesh is not None else 0),
        )
        self._frag_sum = 0.0
        self._frag_ticks = 0
        self._occ_sum = 0.0
        self._attn_fetched = 0
        self._attn_total = 0

    def _init_mesh(self, layout: dict) -> ShardEngine:
        """Validate the (data, model) serving mesh and open the engine on
        it. Refused at construction, as the reference refuses them (all
        ValueError): the contiguous layout, a family that is not
        bucketable (moe, ssm, hybrid: the MoE router is not TP-aware),
        heads/kv heads/d_ff or the usable pool not dividing, and SparCE
        tiles that do not divide the PER-SHARD dims (the summed tile
        counts equal the single-host ones only then). Then RuntimeError
        unless this process is rank 0 of a (dp, tp) mesh."""
        cfg, sc = self.cfg, self.sc
        dp, tp = sc.mesh
        if not self._paged:
            raise ValueError(
                f"ServeConfig.mesh needs the paged KV layout, but family "
                f"{cfg.family!r} fell back to contiguous caches")
        if cfg.family not in model_lib.bucketable_families():
            raise ValueError(
                f"ServeConfig.mesh is not supported for family "
                f"{cfg.family!r}: tensor-parallel serving covers the "
                "dense/vlm/audio stacks (the MoE router is not TP-aware)")
        serve_local_config(cfg, tp)  # raises on non-divisible heads/d_ff
        if self._pool_usable % dp:
            raise ValueError(
                f"serving mesh data axis {dp} must divide the usable "
                f"pool ({self._pool_usable} blocks): each data shard "
                "owns an equal sub-pool (set kv_pool_blocks to a "
                f"multiple of {dp})")
        sp = cfg.sparsity
        if sp is not None and sp.enabled:
            if tp > 1 and (cfg.d_ff // tp) % sp.block_k:
                raise ValueError(
                    f"sparsity block_k={sp.block_k} must divide the "
                    f"per-shard d_ff ({cfg.d_ff}//{tp}="
                    f"{cfg.d_ff // tp}) for exact skip-stat parity "
                    "under tensor parallelism")
            if dp > 1 and (sc.batch_slots // dp) % sp.block_m:
                raise ValueError(
                    f"sparsity block_m={sp.block_m} must divide the "
                    f"per-shard batch_slots ({sc.batch_slots}//"
                    f"{dp}={sc.batch_slots // dp}) for exact "
                    "skip-stat parity under data parallelism")
        from repro_torch.parallel import collectives, worker  # noqa: PLC0415
        mesh = collectives.get_mesh()
        if mesh is None or mesh.shape != {"data": dp, "model": tp}:
            found = "no mesh" if mesh is None else f"mesh {mesh.shape}"
            raise RuntimeError(
                f"ServeConfig.mesh {sc.mesh} needs {dp * tp} ranks on a "
                f"(data, model) mesh, found {found} in this process: start "
                "them with launch/mesh.py:spawn_mesh and run the Server on "
                "rank 0 under parallel/worker.serve_rank")
        self._mesh = mesh
        self._dp, self._tp = dp, tp
        self._b_local = sc.batch_slots // dp
        self._pool_shard = self._pool_usable // dp
        return worker.open_engine(mesh, cfg, self.params, sc, self.device,
                                  **layout)

    # Host-side shard bookkeeping: slot s lives on data shard s //
    # b_local; that shard's allocator hands out LOCAL block ids
    # 1..pool_shard with 0 its own null block, and the tables hold local
    # ids. A single host is one shard.
    def _slot_shard(self, slot: int) -> int:
        return slot // self._b_local

    def _in_use(self) -> int:
        return sum(a.in_use for a in self._st.allocs)

    def _maybe_replan(self) -> None:
        """Re-bucket the measured sparsity into the planner input (only
        with ``SparsityConfig.autotune``). Plans are looked up per call
        from the process cache, so a replan only swaps the config (on
        every rank of a mesh)."""
        sp = self.cfg.sparsity
        if sp is None or not (sp.enabled and sp.autotune):
            return
        bucket = self._ema.bucketed()
        if self._ema.updates >= 2 and bucket != sp.expected_sparsity:
            self.cfg = dataclasses.replace(
                self.cfg,
                sparsity=dataclasses.replace(sp, expected_sparsity=bucket))
            self._engine.call("replan", expected_sparsity=bucket)
            self.metrics.replans += 1

    # ------------------------------------------------------------ sampling
    def _sample(self, logits: np.ndarray) -> np.ndarray:
        """Vectorized sampling over (..., V): greedy or Gumbel-max."""
        if self.sc.temperature <= 0:
            return np.argmax(logits, axis=-1)
        z = logits.astype(np.float64) / self.sc.temperature
        u = self._rng.random(z.shape)
        g = -np.log(-np.log(np.clip(u, 1e-12, 1.0)))
        return np.argmax(z + g, axis=-1)

    # ----------------------------------------------------------- admission
    def _request_need(self, r: Request) -> Tuple[int, int]:
        """(prompt_rows, worst_case_rows): decode tick j writes token j at
        row prompt+j-1 and the last sampled token is never written (the
        vlm patch prefix counts in both). A preempted request's effective
        prompt grew by its resume tokens while its remaining budget shrank
        by as many, so its worst case is that of its first admission."""
        rows0 = (int(self._effective_prompt(r).shape[-1])
                 + self._patch_rows)
        done = len(r.resume_tokens) if r.resume_tokens else 0
        return rows0, rows0 + max(1, r.max_new - done) - 1

    def _bucket_rows(self, r: Request) -> int:
        """Padded prompt rows the request's prefill runs at."""
        S = int(self._effective_prompt(r).shape[-1])
        S_pad = pick_bucket(S, self._buckets) if self._buckets else S
        return S_pad + self._patch_rows

    def _prompt_tokens(self, prompt: np.ndarray, start: int, n: int,
                       S_pad: int) -> np.ndarray:
        """Columns ``start..start+n`` of a prompt ((S,), or (K, S) for
        audio) as a batch of one padded with zeros to ``S_pad``."""
        cfg = self.cfg
        if cfg.frontend == "codes":
            K = cfg.num_codebooks
            toks = np.zeros((1, K, S_pad), np.int64)
            toks[0, :, :n] = prompt.reshape(K, -1)[:, start:start + n]
        else:
            toks = np.zeros((1, S_pad), np.int64)
            toks[0, :n] = prompt.reshape(-1)[start:start + n]
        return toks

    def _prefill_one(self, r: Request, slot: int, caches,
                     block_ids: List[int]):
        """Prefill one request's effective prompt alone and put it in
        ``slot``: padded to its bucket (masked tail, length advanced by
        the TRUE length) for bucketable families, at exact length for the
        rest. The paged layout prefills into a scratch of the prompt's
        rows and scatters them into the pool blocks ``block_ids``; the
        contiguous one into a scratch of the slot cache's row count,
        whose every leaf then overwrites the slot's row. A vlm prompt
        runs behind zero patch embeddings (the frontend's stand-in), in
        the config's dtype."""
        prompt = self._effective_prompt(r)
        S = int(prompt.shape[-1])
        S_pad = pick_bucket(S, self._buckets) if self._buckets else S
        rows0 = S + self._patch_rows
        toks = self._prompt_tokens(prompt, 0, S, S_pad)
        ids = None
        if self._paged:
            ids = np.zeros((self._max_blocks,), np.int64)
            ids[: len(block_ids)] = block_ids
        t0 = time.perf_counter()
        # (V,) or (K, V) logits of the last real row; the skip pair.
        last, skip = self._engine.call(
            "prefill", slot=slot, toks=toks, rows0=rows0,
            scratch_rows=(S_pad + self._patch_rows if self._paged
                          else self._max_rows), block_ids=ids)
        self._prefill_shapes.add(S_pad)
        self.metrics.prefill_s += time.perf_counter() - t0
        self.metrics.prefill_tokens += S
        self.metrics.admitted += 1
        self._count_prefill_skip(skip)
        return last, self._engine.caches

    def _count_prefill_skip(self, skip: np.ndarray) -> None:
        self.metrics.skipped_tile_dots += float(skip[0])
        self.metrics.total_tile_dots += float(skip[1])
        self.metrics.prefill_skipped_tile_dots += float(skip[0])
        self.metrics.prefill_total_tile_dots += float(skip[1])

    def _prefill_suffix(self, r: Request, slot: int, caches,
                        table_row: np.ndarray, prefix_len: int, rows0: int):
        """Continuation prefill: run only the suffix of an effective
        prompt whose first ``prefix_len`` rows already sit in pool blocks
        mapped read-only into ``table_row``. The prefix is gathered out
        of the pool into a batch=1 scratch of ``_ext_rows`` rows pinned
        at length ``prefix_len``; the suffix, padded to its own bucket,
        runs with ``continuation=True``; only its rows are scattered
        back (the shared rows' writes go to the null block). Never for
        the vlm frontend: its patch rows are per-request."""
        n_suffix = rows0 - prefix_len
        S_pad = (pick_bucket(n_suffix, self._buckets) if self._buckets
                 else n_suffix)
        toks = self._prompt_tokens(self._effective_prompt(r), prefix_len,
                                   n_suffix, S_pad)
        t0 = time.perf_counter()
        last, skip = self._engine.call(
            "suffix", slot=slot, toks=toks, n_suffix=n_suffix,
            table_row=np.asarray(table_row, np.int64),
            prefix_len=prefix_len, rows0=rows0)
        self._prefill_shapes.add(("suffix", S_pad))
        self.metrics.prefill_s += time.perf_counter() - t0
        # Only the suffix ran; the matched rows are counted in
        # prefix_matched_tokens.
        self.metrics.prefill_tokens += n_suffix
        self.metrics.admitted += 1
        self._count_prefill_skip(skip)
        return last, self._engine.caches

    def _finish(self, s: _Slot, t_now: float) -> None:
        r = s.req
        item = s.item
        out = np.array(s.produced[: r.max_new])
        r.out = out
        prior = r.stats  # preemption bookkeeping stashed by _preempt
        r.stats = {
            "ttft_s": s.t_first - item.arrival_s,
            "latency_s": t_now - item.arrival_s,
            "tokens": float(len(out)),
            "decode_ticks": float(s.ticks),
            "queue_ticks": s.admit_vt - item.arrival_vt,
            "ttft_ticks": s.first_vt - item.arrival_vt,
            "itl_ticks_max": s.itl_max,
        }
        if "preemptions" in prior:
            # TTFT belongs to the first admission, not the restore.
            r.stats["preemptions"] = prior["preemptions"]
            r.stats["ttft_ticks"] = prior.get("ttft_ticks",
                                              r.stats["ttft_ticks"])
            r.stats["ttft_s"] = prior.get("ttft_s", r.stats["ttft_s"])
        self.metrics.completed += 1

    def _hit_eos(self, r: Request, tok: np.ndarray) -> bool:
        eos = r.eos_id if r.eos_id is not None else self.sc.eos_id
        if eos is None:
            return False
        if self.cfg.frontend == "codes":
            return bool(np.all(tok == eos))  # every codebook at EOS
        return int(tok) == eos

    # -------------------------------------------------------------- engine
    def _validate(self, requests: List[Request]) -> None:
        """Reject requests that can never fit before admitting any."""
        want = 2 if self.cfg.frontend == "codes" else 1
        for r in requests:
            prompt = np.asarray(r.prompt)
            if prompt.ndim != want:
                raise ValueError(
                    f"request uid={r.uid}: prompt must be "
                    + ("(K, S) codebook ids" if want == 2
                       else "1-D token ids")
                    + f", got shape {prompt.shape}")
            need = int(prompt.shape[-1]) + max(1, r.max_new)
            if need > self.sc.max_len:
                raise ValueError(
                    f"request uid={r.uid}: prompt + max_new = {need} "
                    f"tokens do not fit a max_len={self.sc.max_len} cache "
                    "slot; raise ServeConfig.max_len or lower max_new")
            if not self._paged:
                continue
            _, worst = self._request_need(r)
            nb = blocks_needed(worst, self.sc.kv_block_size)
            # On a mesh a slot lives inside its data shard's sub-pool.
            if nb > self._pool_shard:
                what = (f"{self._pool_shard}-block per-shard pool"
                        if self._mesh is not None
                        else f"{self._pool_usable}-block pool")
                raise ValueError(
                    f"request uid={r.uid}: worst case {nb} KV blocks do "
                    f"not fit the {what}; raise "
                    "ServeConfig.kv_pool_blocks")

    def start_engine(self) -> None:
        """(Re)initialize caches, pool, slots, queue, cancel marks, fault
        injector and virtual clock for a run. Metrics and latency samples
        accumulate across runs, as the reference's do."""
        cfg, sc = self.cfg, self.sc
        B = sc.batch_slots
        if self._queue.depth():
            raise RuntimeError(
                "start_engine() with requests still queued: drain or "
                "discard the previous run first")
        # Fresh caches on every device: one sub-pool (with its own null
        # block 0) per data shard, or the contiguous slot caches.
        self._engine.call("reset")
        allocs: List[BlockAllocator] = []
        tables: Optional[np.ndarray] = None
        if self._paged:
            allocs = [BlockAllocator(self._pool_shard)
                      for _ in range(self._dp)]
            tables = np.zeros((B, self._max_blocks), np.int32)
        self._queue = RequestQueue(max_depth=sc.max_queue_depth)
        with self._cancel_lock:
            self._cancel_pending.clear()
        # Fresh injector per run: the fault schedule is a function of
        # (plan, workload), not of how many runs this Server has served.
        self._inj = FaultInjector(sc.faults) if sc.faults else None
        self._inj_seen = 0
        # Fresh virtual clock per run, so a reused Server replays a trace
        # to the same schedule.
        self._vt = 0.0
        # A fresh index per run and data shard: its blocks belong to
        # this run's (sub-)pool.
        self._prefixes = ([PrefixCache(a, sc.kv_block_size) for a in allocs]
                          if sc.prefix_cache else None)
        self._prefix = self._prefixes[0] if self._prefixes else None
        self._st = _EngineState(
            engine=self._engine, alloc=allocs[0] if allocs else None,
            tables=tables, allocs=allocs,
            slots=[None] * B,
            cur_tok=np.zeros((B, cfg.num_codebooks) if cfg.frontend
                             == "codes" else (B,), np.int64),
            completed=[],
        )

    def enqueue(self, r: Request, *, priority: float = 0.0,
                deadline_ticks: Optional[float] = None,
                arrival_vt: Optional[float] = None) -> QueuedRequest:
        """Queue a request (arrival stamped at the current virtual time
        unless given). Thread-safe. Raises :class:`ServerOverloaded`,
        counted in ``metrics.shed_requests``, when the shed policy or the
        queue's depth bound rejects the push; nothing is enqueued."""
        try:
            if self._sched.should_shed(self._queue.depth()):
                raise ServerOverloaded(
                    f"admission queue at max_depth="
                    f"{self.sc.max_queue_depth}: request uid={r.uid} "
                    "shed")
            return self._queue.push(
                r, priority=priority, deadline_ticks=deadline_ticks,
                arrival_vt=self._vt if arrival_vt is None else arrival_vt)
        except ServerOverloaded:
            self.metrics.shed_requests += 1
            raise

    def cancel(self, uid: int) -> None:
        """Mark a submitted request cancelled. Thread-safe; the engine
        collects it at its next step boundary (a queued entry is purged,
        a live slot is evicted with its blocks released). Unknown or
        finished uids are a no-op."""
        with self._cancel_lock:
            self._cancel_pending.add(uid)

    def queue_depth(self) -> int:
        return self._queue.depth()

    @property
    def failed(self) -> List[Request]:
        """Requests that failed this run (cancelled or request-scoped
        fault), for sync drivers; empty when an ``on_error`` consumer
        takes them instead."""
        return list(self._st.failed) if self._st is not None else []

    def any_active(self) -> bool:
        st = self._st
        return st is not None and any(s is not None for s in st.slots)

    @property
    def vt(self) -> float:
        """The engine's virtual clock, in decode-tick units."""
        return self._vt

    def advance_vt(self, to_vt: float) -> None:
        """Advance the virtual clock across an IDLE gap (open-loop
        drivers jump to the next arrival); never rewinds."""
        self._vt = max(self._vt, float(to_vt))

    def _outstanding_commit(self, shard: Optional[int] = None) -> int:
        """Blocks promised to live slots but not yet allocated (of one
        data shard's slots, or of all)."""
        return sum(s.commit - len(s.blocks)
                   for i, s in enumerate(self._st.slots)
                   if s is not None
                   and (shard is None or self._slot_shard(i) == shard))

    def _record_first_token(self, s: _Slot) -> None:
        item = s.item
        ttft = s.first_vt - item.arrival_vt
        self._ttft_ticks_all.append(ttft)
        self._ttft_s_all.append(s.t_first - item.arrival_s)
        if ttft > self._sched.ttft_budget(item.deadline_ticks):
            self.metrics.slo_ttft_violations += 1

    def _emit_token(self, r: Request, tok: np.ndarray) -> None:
        if self.on_token is not None:
            self.on_token(r, tok)

    def _release_slot_resources(self, i: int, s: _Slot) -> None:
        """Return slot ``i``'s blocks to the pool (paged layout) and clear
        the slot: the shared tail of every way a slot ends (finish,
        cancel, fault, preemption). The paged layout ends with the
        allocator's full check against the engine's ledger."""
        st = self._st
        s.released = True
        st.slots[i] = None
        if not self._paged:
            return
        # Blocks and refs go back to the OWNER shard's allocator, the one
        # every id in this slot's table is local to.
        owner = self._slot_shard(i)
        alloc = st.allocs[owner]
        if s.blocks:
            alloc.release(s.blocks)
        if s.shared:
            # This slot's references on the read-only prefix blocks; the
            # index's own (and other sharers') keep them in the pool.
            alloc.release(s.shared)
            s.shared = []
        # Return the UNUSED tail of the worst-case commitment (raises on
        # a double count); shared blocks were never part of it.
        alloc.unreserve(s.commit - len(s.blocks))
        s.commit = len(s.blocks)
        st.tables[i, :] = 0
        alloc.check(expect_reserved=self._outstanding_commit(owner))

    def _release(self, i: int) -> None:
        st = self._st
        s = st.slots[i]
        if s is None or s.released:
            raise RuntimeError(f"slot {i} released twice")
        self._finish(s, time.perf_counter())
        if self.on_finish is None:
            # Sync drivers read completions from the engine state; with
            # an on_finish consumer nothing accumulates here.
            st.completed.append(s.req)
        self._release_slot_resources(i, s)
        if self.on_finish is not None:
            self.on_finish(s.req)

    def _record_failure(self, r: Request, err: ServingError) -> None:
        """Bookkeeping of a request that FAILS instead of finishing: the
        error and its metric, then the on_error consumer (or the sync
        ``failed`` list)."""
        r.error = err
        if isinstance(err, RequestCancelled):
            self.metrics.cancelled += 1
        else:
            self.metrics.failed_requests += 1
        if self.on_error is None:
            self._st.failed.append(r)
        else:
            self.on_error(r, err)

    def _fail_slot(self, i: int, err: ServingError) -> None:
        """Evict a LIVE slot whose request failed (cancel, deadline, a
        contained fault): resources released, ledger re-checked, partial
        output attached, waiters notified."""
        st = self._st
        s = st.slots[i]
        if s is None or s.released:
            raise RuntimeError(f"slot {i} failed after release")
        r = s.req
        r.out = np.array(s.produced[: r.max_new])  # partial tokens
        r.stats = {
            "tokens": float(len(r.out)),
            "decode_ticks": float(s.ticks),
            "queue_ticks": s.admit_vt - s.item.arrival_vt,
        }
        self._release_slot_resources(i, s)
        self._record_failure(r, err)

    def _fail_queued(self, item: QueuedRequest, err: ServingError) -> None:
        """Fail a request no longer in the queue (popped or removed by
        the caller): nothing to release, only the bookkeeping."""
        item.req.out = np.zeros((0,), np.int64)
        self._record_failure(item.req, err)

    def _process_cancellations(self) -> None:
        """Collect ``cancel()`` marks at a step boundary, before
        admission, so a cancelled head never costs a prefill."""
        with self._cancel_lock:
            if not self._cancel_pending:
                return
            uids, self._cancel_pending = self._cancel_pending, set()
        for item in self._queue.remove_if(lambda e: e.req.uid in uids):
            self._fail_queued(item, RequestCancelled(
                f"request uid={item.req.uid} cancelled while queued"))
        for i, s in enumerate(self._st.slots):
            if s is not None and s.req.uid in uids:
                self._fail_slot(i, RequestCancelled(
                    f"request uid={s.req.uid} cancelled mid-decode"))

    def _sync_fault_metrics(self) -> None:
        """Fold the injector's fire count into the metrics (only the
        delta since the last sync)."""
        if self._inj is not None and self._inj.injected > self._inj_seen:
            self.metrics.faults_injected += (
                self._inj.injected - self._inj_seen)
            self._inj_seen = self._inj.injected

    def _grow_one(self, alloc: BlockAllocator, i: int,
                  s: _Slot) -> Optional[int]:
        """One lazy-growth block for slot ``i`` through the injector's
        allocator gate, with bounded retries: a transient fault that
        clears within ``_GROW_RETRIES`` retries is recovered; exhaustion
        (or a transient that outlives the retries) fails the REQUEST and
        returns None with the slot already evicted."""
        uid = s.req.uid
        gidx = len(s.blocks)
        attempt = 0
        while True:
            try:
                if self._inj is not None:
                    self._inj.alloc_gate(uid, gidx, attempt)
                (blk,) = alloc.alloc(1, reserved=True)
            except InjectedFault as e:
                self._sync_fault_metrics()
                if e.transient and attempt < _GROW_RETRIES:
                    attempt += 1
                    continue
                reason = (f"transient fault outlived {_GROW_RETRIES} "
                          "retries" if e.transient
                          else "injected allocator exhaustion")
                err = RequestFailed(
                    f"request uid={uid}: KV block growth failed "
                    f"({reason})")
                err.__cause__ = e
                self._fail_slot(i, err)
                self.metrics.faults_recovered += 1  # contained
                return None
            if attempt:
                # A transient fault cleared within the retry budget.
                self.metrics.faults_recovered += 1
            self._sync_fault_metrics()
            return blk

    # ---------------------------------------------------- preempt/requeue
    def _full_sequence(self, r: Request,
                       produced: List[np.ndarray]) -> np.ndarray:
        """prompt ++ produced, in the prompt's layout ((S,), or (K, S) for
        audio): what a preempted request re-prefills."""
        prompt = np.asarray(r.prompt)
        if not produced:
            return prompt
        if self.cfg.frontend == "codes":
            K = self.cfg.num_codebooks
            return np.concatenate(
                [prompt.reshape(K, -1)]
                + [np.asarray(t).reshape(K, 1) for t in produced], axis=-1)
        return np.concatenate(
            [prompt.reshape(-1), np.asarray(produced, np.int64).reshape(-1)])

    def _effective_prompt(self, r: Request) -> np.ndarray:
        """The original prompt, plus every token produced before a
        preemption (the last of which is the token whose decode tick the
        preemption squashed: re-running it as the prefill's last row
        gives the restored next token)."""
        if r.resume_tokens:
            return self._full_sequence(r, r.resume_tokens)
        return np.asarray(r.prompt)

    def _free_wait_ticks(self) -> float:
        """Ticks until the earliest natural release (a live slot running
        out of its budget): the stall a reclaim is weighed against."""
        rem = [s.req.max_new - len(s.produced)
               for s in self._st.slots if s is not None]
        return float(min(rem)) + 1.0 if rem else float("inf")

    def _restore_ticks(self, s: _Slot) -> float:
        """Modeled cost of restoring a victim later: the bucketed
        re-prefill of its effective prompt, minus the full written blocks
        the prefix cache keeps from the preemption."""
        rows_eff = s.cache_len + 1  # written rows + the unwritten token
        if self._prefix is not None:
            bs = self.sc.kv_block_size
            suffix = rows_eff - (s.cache_len // bs) * bs
        else:
            suffix = rows_eff
        rows = pick_bucket(suffix, self._buckets) if self._buckets \
            else suffix
        return self._costs.prefill_ticks(rows)

    def _pick_victim(self, head_priority: float,
                     shard: Optional[int] = None) -> Optional[int]:
        """Among live slots of priority STRICTLY below the head's (a peer
        is never preempted: the requeue boost would livelock two
        equals), the lowest-priority, most recently admitted one;
        ``shard`` keeps to one data shard's slots (blocks are fungible
        only within a sub-pool)."""
        st = self._st
        best: Optional[int] = None
        for i, s in enumerate(st.slots):
            if s is None or s.item.priority >= head_priority:
                continue
            if shard is not None and self._slot_shard(i) != shard:
                continue
            if best is None:
                best = i
                continue
            b = st.slots[best]
            if (s.item.priority, -s.admit_vt) < (b.item.priority,
                                                 -b.admit_vt):
                best = i
        return best

    def _preempt(self, i: int, head_priority: float) -> None:
        """Evict live slot ``i`` to fund a forced-TTFT admission. Its
        written full blocks are registered in the prefix cache first (the
        index's reference keeps them through the release), so its restore
        is suffix-only unless eviction takes them meanwhile. The victim
        requeues with its tokens as resume state at a priority between
        its own and the head's."""
        st = self._st
        s = st.slots[i]
        r = s.req
        bs = self.sc.kv_block_size
        prefix = (self._prefixes[self._slot_shard(i)]
                  if self._prefixes is not None else None)
        if prefix is not None:
            n_full = s.cache_len // bs
            if n_full:
                written = self._full_sequence(
                    r, s.produced)[..., : s.cache_len]
                keys = PrefixCache.chain_keys(written, bs)
                prefix.register(
                    keys[:n_full], [int(b) for b in st.tables[i, :n_full]])
        self._release_slot_resources(i, s)
        r.resume_tokens = [np.asarray(t) for t in s.produced]
        boosted = (s.item.priority + head_priority) / 2.0
        self._queue.push(
            r, priority=boosted, arrival_vt=s.item.arrival_vt,
            arrival_s=s.item.arrival_s,
            deadline_ticks=s.item.deadline_ticks, force=True)
        r.stats["preemptions"] = r.stats.get("preemptions", 0.0) + 1.0
        # TTFT is a property of the FIRST admission; a second preemption
        # must not overwrite it.
        r.stats.setdefault("ttft_ticks", s.first_vt - s.item.arrival_vt)
        r.stats.setdefault("ttft_s", s.t_first - s.item.arrival_s)
        self.metrics.preemptions += 1
        self.metrics.requeues += 1

    def _maybe_reclaim(self, item: QueuedRequest, *,
                       shard: Optional[int]) -> bool:
        """Ask the reclaim policy whether to preempt a victim for queue
        head ``item``; preempt ONE if approved. ``shard=None`` reclaims a
        slot (any shard); a shard index reclaims BLOCKS, which must come
        from that shard's sub-pool. True when a victim was evicted (the
        caller retries)."""
        if not self.sc.preempt:
            return False
        v = self._pick_victim(item.priority, shard)
        if v is None:
            return False
        pt = self._costs.prefill_ticks(self._bucket_rows(item.req))
        if not self._sched.should_reclaim(
                wait_ticks=self._vt - item.arrival_vt,
                prefill_ticks=pt,
                deadline_ticks=item.deadline_ticks,
                restore_ticks=self._restore_ticks(self._st.slots[v]),
                free_wait_ticks=self._free_wait_ticks()):
            return False
        self._preempt(v, item.priority)
        return True

    def _admission_phase(self) -> int:
        """Admit queue heads into free slots, scheduler-gated; a head
        that does not fit the pool, or that the scheduler defers, blocks
        everything behind it (deterministic order). With ``preempt`` a
        forced head finding no free slot may first evict one victim."""
        st = self._st
        self._sched.begin_round()
        admitted = 0
        if (self.sc.preempt and self._queue.depth()
                and all(s is not None for s in st.slots)):
            # No free slot: the slot form of reclaim (the block-pressure
            # form runs inside the loop below).
            head = self._queue.peek()
            if head is not None:
                self._maybe_reclaim(head, shard=None)
        for i in range(self.sc.batch_slots):
            while st.slots[i] is None:
                res = self._try_admit_head(i)
                if res == "retry":
                    continue  # a preemption or a containment changed state
                if res in ("full", "defer"):
                    return admitted  # head-of-line: nothing else moves
                if res == "admitted":
                    admitted += 1
                break  # admitted (maybe released at once) or empty
        return admitted

    def _try_admit_head(self, i: int) -> str:
        """One attempt to admit the queue head into free slot ``i``:
        ``"empty"``, ``"defer"`` (the scheduler spends the gap on the
        decode tick), ``"full"`` (wait for a release), ``"retry"`` (a
        victim was preempted or a faulted head contained) or
        ``"admitted"``."""
        st, sc = self._st, self.sc
        item = self._queue.peek()
        if item is None:
            return "empty"
        r = item.req
        # A preempted request re-prefills its EFFECTIVE prompt; all below
        # prices and allocates for it.
        resumed = bool(r.resume_tokens)
        rows0, worst = self._request_need(r)
        bs = sc.kv_block_size
        # Everything below runs against the OWNER data shard's allocator
        # and prefix index: slot i's blocks live in its sub-pool.
        owner = self._slot_shard(i)
        alloc = st.allocs[owner] if self._paged else None
        prefix = (self._prefixes[owner] if self._prefixes is not None
                  else None)
        # Prefix-cache probe. lookup() RETAINS every matched block for
        # this request, so every bail-out below releases them. A restore
        # finds the blocks registered at its preemption.
        keys: List[bytes] = []
        shared: List[int] = []
        cow = False
        if prefix is not None:
            keys = PrefixCache.chain_keys(self._effective_prompt(r), bs)
            shared = prefix.lookup(keys)
            self.metrics.prefix_lookups += 1
            if shared:
                self.metrics.prefix_hits += 1
            # Full-prompt match: the last prompt row must re-run for its
            # logits and needs a writable home, so the block holding it
            # is forked copy-on-write below.
            cow = bool(shared) and len(shared) * bs == rows0
        commit = 0
        if self._paged:
            # Shared blocks are never allocated, so they drop out of the
            # worst-case commitment (the CoW fork stays in: it is owned).
            commit = blocks_needed(worst, bs) - (
                len(shared) - 1 if cow else len(shared))
            if not alloc.can_reserve(commit):
                # Evict blocks only the index holds; the matched ones
                # hold our reference too, so eviction cannot take them.
                if prefix is not None:
                    prefix.evict_for(commit)
                if not alloc.can_reserve(commit):
                    if shared:
                        alloc.release(shared)
                    # Block pressure: a victim on THIS shard can fund the
                    # head (its blocks return to the same sub-pool).
                    if self._maybe_reclaim(item, shard=owner):
                        return "retry"
                    return "full"
        n_active = sum(1 for s in st.slots if s is not None)
        pt_full = self._costs.prefill_ticks(self._bucket_rows(r))
        n_suffix, prefix_len = rows0, 0
        if shared:
            n_suffix = 1 if cow else rows0 - len(shared) * bs
            prefix_len = rows0 - n_suffix
        suffix_rows = (pick_bucket(n_suffix, self._buckets) if self._buckets
                       else n_suffix)
        # A hit is priced at the suffix bucket: the work that runs.
        pt = self._costs.prefill_ticks(suffix_rows) if prefix_len else pt_full
        if not self._sched.admit_head(
                wait_ticks=self._vt - item.arrival_vt, prefill_ticks=pt,
                n_active=n_active, deadline_ticks=item.deadline_ticks):
            if shared:
                alloc.release(shared)
            return "defer"  # SLO: spend the gap on the decode tick
        block_ids: List[int] = []
        if self._paged:
            if not alloc.try_reserve(commit):
                if shared:
                    alloc.release(shared)
                if self._maybe_reclaim(item, shard=owner):
                    return "retry"
                return "full"
            if cow:
                # The allocator's fork first, then the device copy:
                # queued on the current stream before the suffix prefill,
                # which gathers the prefix through the table on the same
                # stream.
                block_ids = [alloc.fork(shared[-1], reserved=True)]
                self._engine.call("copy", slot=i, dst=block_ids[0],
                                  src=shared.pop())
                self.metrics.prefix_cow_forks += 1
            else:
                block_ids = alloc.alloc(
                    blocks_needed(rows0, bs) - len(shared), reserved=True)
            # The read-only shared run first, owned blocks after it.
            st.tables[i, : len(shared)] = shared
            st.tables[i, len(shared): len(shared) + len(block_ids)] = (
                block_ids)
            # Sampled here too: a request that ends on its prefill token
            # never reaches a decode tick but held blocks.
            self.metrics.kv_blocks_peak_in_use = max(
                self.metrics.kv_blocks_peak_in_use, float(self._in_use()))
        # By identity: a concurrent submit may have pushed a new,
        # higher-priority head between our peek and now.
        self._queue.pop_expected(item)
        t0 = time.perf_counter()
        admit_vt = self._vt
        try:
            if self._inj is not None and self._inj.poison(r.uid):
                self._sync_fault_metrics()
                raise InjectedFault("poison_prompt", r.uid)
            if prefix_len:
                last_logits, _ = self._prefill_suffix(
                    r, i, st.caches, st.tables[i], prefix_len, rows0)
            else:
                last_logits, _ = self._prefill_one(
                    r, i, st.caches, block_ids)
        except Exception as e:
            if not is_request_scoped(e):
                raise  # engine-fatal (a CUDA error is sticky)
            # Containment: roll back everything this admission took --
            # owned blocks, shared refs, the commitment tail -- and
            # re-prove the pool before serving anyone else.
            if self._paged:
                if block_ids:
                    alloc.release(block_ids)
                if shared:
                    alloc.release(shared)
                alloc.unreserve(commit - len(block_ids))
                st.tables[i, :] = 0
                alloc.check(expect_reserved=self._outstanding_commit(owner))
            err = RequestFailed(f"request uid={r.uid} failed in prefill: {e}")
            err.__cause__ = e
            self._fail_queued(item, err)
            if isinstance(e, InjectedFault):
                self.metrics.faults_recovered += 1
            return "retry"
        self._vt += pt
        self._vt_prefill += pt
        if resumed:
            # The realized squash penalty the reclaim policy traded.
            self.metrics.preempt_restore_ticks += pt
        if prefix is not None:
            # pt_full is what the cache-off engine spends on every
            # admission; a hit keeps pt_full - pt off the virtual clock.
            self.metrics.prefill_ticks_nocache += pt_full
            if prefix_len:
                self.metrics.prefix_matched_tokens += prefix_len
                self.metrics.prefix_blocks_shared += len(shared)
                self.metrics.prefill_ticks_saved += pt_full - pt
                self.metrics.prefill_flops_saved += (
                    self._costs.prefill_flops(self._bucket_rows(r))
                    - self._costs.prefill_flops(suffix_rows))
            # Publish the prompt's full blocks; register() keeps the
            # incumbent of a known key, so a CoW fork stays private.
            n_full = rows0 // bs
            if n_full:
                prefix.register(keys[:n_full],
                                [int(b) for b in st.tables[i, :n_full]])
        first = self._sample(last_logits)
        # A restore carries its earlier tokens back in; its prefill's
        # last row re-ran the squashed tick, so ``first`` is that tick's
        # token.
        carried = ([np.asarray(t) for t in r.resume_tokens]
                   if resumed else [])
        s = _Slot(
            req=r, item=item, produced=carried + [np.asarray(first)],
            t_admit=t0, t_first=time.perf_counter(), cache_len=rows0,
            blocks=block_ids, shared=shared, commit=commit,
            admit_vt=admit_vt, first_vt=self._vt, last_token_vt=self._vt,
        )
        st.slots[i] = s
        st.cur_tok[i] = first
        self.admitted_uids.append(r.uid)
        if resumed:
            r.resume_tokens = None  # consumed: the tokens live in the slot
        else:
            # TTFT belongs to the FIRST admission only.
            self._record_first_token(s)
        self._emit_token(r, np.asarray(first))
        if len(s.produced) >= r.max_new or self._hit_eos(
                r, np.asarray(first)):
            self._release(i)  # budget reached / instant EOS: reuse slot
        return "admitted"

    def _decode_tick(self) -> int:
        """One decode tick for all slots (dead slots masked). Returns the
        number of live slots decoded (0 = no-op)."""
        st, sc = self._st, self.sc
        B = sc.batch_slots
        if self._inj is not None:
            # Request-scoped step faults: that slot is evicted (resources
            # back, ledger re-proved) and the tick goes on for the rest.
            for i, s in enumerate(st.slots):
                if s is None:
                    continue
                if self._inj.step_fault_one(s.req.uid, s.ticks):
                    self._sync_fault_metrics()
                    err = RequestFailed(
                        f"request uid={s.req.uid} hit an injected step "
                        f"fault at decode tick {s.ticks}")
                    err.__cause__ = InjectedFault("step", s.req.uid)
                    self._fail_slot(i, err)
                    self.metrics.faults_recovered += 1
        if not any(s is not None for s in st.slots):
            return 0
        if self._paged:
            self._grow_and_account()
        active = np.array([s is not None for s in st.slots], np.float32)
        n_active = int(active.sum())
        if n_active == 0:
            return 0  # a growth fault evicted the last live slot
        slo = sc.slo

        live = active.astype(bool)
        step = np.where(live[:, None] if st.cur_tok.ndim > 1 else live,
                        st.cur_tok, 0)
        t0 = time.perf_counter()
        # (B, V), or (B, K, V) for audio; the summed skip pair.
        last, skip = self._engine.call("decode", step=step, active=active,
                                       tables=st.tables)
        self.metrics.decode_s += time.perf_counter() - t0
        self.metrics.ticks += 1
        self.metrics.decode_tokens += n_active
        self._vt += 1.0
        self._vt_decode += 1.0
        self.metrics.skipped_tile_dots += float(skip[0])
        self.metrics.total_tile_dots += float(skip[1])
        self._ema.update(float(skip[0]), float(skip[1]))
        self._maybe_replan()

        nxt = self._sample(last)  # (B,) or (B, K)
        for i in range(B):
            s = st.slots[i]
            if s is None:
                continue
            tok = np.asarray(nxt[i])
            s.produced.append(tok)
            s.ticks += 1
            s.cache_len += 1  # this tick wrote cur_tok at cache_len
            gap = self._vt - s.last_token_vt
            s.last_token_vt = self._vt
            s.itl_max = max(s.itl_max, gap)
            self._itl_ticks_all.append(gap)
            if slo is not None and gap > slo.target_itl_ticks:
                self.metrics.slo_itl_violations += 1
            st.cur_tok[i] = tok
            self._emit_token(s.req, tok)
            if len(s.produced) >= s.req.max_new or self._hit_eos(s.req, tok):
                self._release(i)
            elif (s.req.max_ticks is not None
                  and len(s.produced) - 1 >= s.req.max_ticks):
                # The decode deadline. len(produced) - 1 counts progress
                # past the first token and does not change under a
                # preemption (the restore re-produces the squashed
                # tick's token). Finishing (EOS/budget) wins above.
                self._fail_slot(i, RequestCancelled(
                    f"request uid={s.req.uid}: max_ticks="
                    f"{s.req.max_ticks} decode budget exhausted"))
        return n_active

    def _grow_and_account(self) -> None:
        """The paged layout's part of a decode tick before the step: lazy
        block growth, then the pool's peak, ledger, fragmentation,
        occupancy and attention-fetch accounting."""
        st, sc = self._st, self.sc
        # Lazy growth: a slot crossing a block edge claims its next pool
        # block when the write reaches it; the admission commitment
        # guarantees the free list covers it, so only an injected
        # allocator fault can fail it.
        for i, s in enumerate(st.slots):
            if s is None:
                continue
            blk_idx = s.cache_len // sc.kv_block_size
            if blk_idx >= len(s.shared) + len(s.blocks):
                new_blk = self._grow_one(st.allocs[self._slot_shard(i)],
                                         i, s)
                if new_blk is None:
                    continue  # growth failed: the slot was evicted
                s.blocks.append(new_blk)
                st.tables[i, blk_idx] = new_blk
        # The accounting after growth: a growth fault may have evicted a
        # slot.
        if not any(s is not None for s in st.slots):
            return
        self.metrics.kv_blocks_peak_in_use = max(
            self.metrics.kv_blocks_peak_in_use, float(self._in_use()))
        # Each shard allocator's reservation against the engine's ledger
        # of the slots it owns.
        for sh, a in enumerate(st.allocs):
            if a.reserved != self._outstanding_commit(sh):
                raise AssertionError(
                    f"commitment ledger mismatch on shard {sh}: engine "
                    f"expects {self._outstanding_commit(sh)} outstanding, "
                    f"allocator holds {a.reserved}")
        used_rows = sum(s.cache_len + 1 for s in st.slots if s is not None)
        # Each slot's MAPPED blocks: a shared block once per sharer.
        cap_rows = sum((len(s.shared) + len(s.blocks)) * sc.kv_block_size
                       for s in st.slots if s is not None)
        if cap_rows:
            self._frag_sum += 1.0 - used_rows / cap_rows
            self._frag_ticks += 1
        self._occ_sum += self._in_use() / max(1, self._pool_usable)
        # Attention fetch accounting in block-table units.
        eff = [0 if s is None else s.cache_len + 1 for s in st.slots]
        fetched, total = decode_attn_block_counts(
            eff, self._max_blocks, sc.kv_block_size)
        self._attn_fetched += fetched
        self._attn_total += total

    def step(self) -> Dict[str, int]:
        """One engine iteration: cancellations, an admission phase, then
        (if anything is live) one decode tick."""
        if self._st is None:
            raise RuntimeError("start_engine() before step()")
        self._process_cancellations()
        admitted = self._admission_phase()
        decoded = self._decode_tick()
        return {"admitted": admitted, "decoded": decoded}

    def serve_trace(self, trace, *, priorities=None,
                    deadlines=None) -> List[Request]:
        """Serve an open-loop arrival trace ``[(arrival_vt, Request)]``
        on the virtual clock: each request is enqueued when the clock
        reaches its arrival (idle gaps fast-forward), so the run --
        admission order, TTFT/ITL percentiles, SLO violations,
        preemptions, sheds -- is a function of the trace, the config and
        the fault plan. ``priorities``/``deadlines`` map uid -> priority
        / TTFT deadline in ticks. A shed arrival gets ``out = []`` and
        its ``ServerOverloaded`` on ``error``."""
        self._validate([r for _, r in trace])
        self.start_engine()
        items = sorted(enumerate(trace), key=lambda e: (e[1][0], e[0]))
        i = 0
        while True:
            while i < len(items) and items[i][1][0] <= self._vt + 1e-9:
                _, (avt, r) = items[i]
                try:
                    self.enqueue(
                        r, arrival_vt=float(avt),
                        priority=(priorities or {}).get(r.uid, 0.0),
                        deadline_ticks=(deadlines or {}).get(r.uid))
                except ServerOverloaded as e:
                    # Shed under the depth bound: counted, and the trace
                    # drives on.
                    r.out = np.zeros((0,), np.int64)
                    r.error = e
                i += 1
            if self.queue_depth() == 0 and not self.any_active():
                if i >= len(items):
                    break
                self.advance_vt(items[i][1][0])  # idle to next arrival
                continue
            self.step()
        self.finalize_metrics()
        return list(self._st.completed)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a fixed request list through the engine and drain it
        (drain mode without an SLO; with one, admission interleaves
        under it)."""
        self._validate(requests)
        self.start_engine()
        for r in requests:
            self.enqueue(r)
        while self.queue_depth() or self.any_active():
            self.step()
        self.finalize_metrics()
        return list(self._st.completed)

    def prefill_trace_count(self) -> int:
        """Distinct prefill bucket shapes served (the port's counterpart
        of the reference's compiled prefill trace count)."""
        return len(self._prefill_shapes)

    def finalize_metrics(self) -> ServeMetrics:
        """Fold the run's accumulators into ``metrics``."""
        m = self.metrics
        self._sync_fault_metrics()
        if m.total_tile_dots > 0:
            m.mlp_skip_fraction = m.skipped_tile_dots / m.total_tile_dots
        self._account_modeled_bytes()
        self._account_kv_bytes()
        m.queue_depth = float(self._queue.depth())
        m.queue_depth_peak = float(self._queue.depth_peak)
        for q in (50, 95, 99):
            setattr(m, f"ttft_ticks_p{q}", _pct(self._ttft_ticks_all, q))
            setattr(m, f"itl_ticks_p{q}", _pct(self._itl_ticks_all, q))
        m.ttft_s_p50 = _pct(self._ttft_s_all, 50)
        m.ttft_s_p99 = _pct(self._ttft_s_all, 99)
        m.sched_admitted = float(self._sched.admitted)
        m.sched_deferred = float(self._sched.deferred)
        m.sched_forced = float(self._sched.forced)
        vt_total = self._vt_prefill + self._vt_decode
        if vt_total > 0:
            m.prefill_tick_share = self._vt_prefill / vt_total
            m.decode_tick_share = self._vt_decode / vt_total
        if self._prefixes is not None:
            m.prefix_evicted_blocks = float(
                sum(p.evicted for p in self._prefixes))
            m.prefix_cache_blocks = float(sum(len(p) for p in self._prefixes))
        if m.prefix_lookups > 0:
            m.prefix_hit_rate = m.prefix_hits / m.prefix_lookups
        if m.prefill_ticks_nocache > 0:
            m.prefill_ticks_saved_frac = (
                m.prefill_ticks_saved / m.prefill_ticks_nocache)
        return m

    def _account_kv_bytes(self) -> None:
        """Modeled KV reservation: the pool vs the contiguous layout."""
        row_b = cost_model.kv_row_bytes(self.cfg)
        res = cost_model.kv_reservation_bytes(
            self.sc.batch_slots, self._max_rows, row_b,
            pool_blocks=self._pool_usable if self._paged else None,
            block_size=self.sc.kv_block_size if self._paged else 0)
        m = self.metrics
        m.kv_bytes_reserved = float(res["paged"])
        m.kv_bytes_reserved_contiguous = float(res["contiguous"])
        m.kv_bytes_saved_frac = float(res["saved_frac"])
        generated = m.decode_tokens + m.admitted
        if generated:
            m.kv_reserved_bytes_per_token = float(res["paged"]) / generated
        if self._pool_usable:
            m.kv_pool_peak_occupancy = (
                m.kv_blocks_peak_in_use / self._pool_usable)
        if self._frag_ticks:
            m.kv_internal_frag = self._frag_sum / self._frag_ticks
        if m.ticks:
            m.kv_pool_mean_occupancy = self._occ_sum / m.ticks
        m.prefill_traces = float(self.prefill_trace_count())
        self._account_attn_bytes(row_b)

    def _account_attn_bytes(self, row_bytes: int) -> None:
        """Modeled decode-attention fetch bytes: live blocks (paged
        kernel) vs the full view (gather path), all attention layers."""
        m = self.metrics
        m.attn_blocks_fetched = float(self._attn_fetched)
        m.attn_blocks_total = float(self._attn_total)
        if not self._attn_total:
            return
        by = cost_model.decode_attn_hbm_bytes(
            blocks_fetched=self._attn_fetched,
            blocks_total=self._attn_total,
            block_size=self.sc.kv_block_size, row_bytes=row_bytes)
        m.attn_block_skip_fraction = (
            1.0 - self._attn_fetched / self._attn_total)
        m.attn_bytes_gather = float(by["gather"])
        m.attn_bytes_paged = float(by["paged"])
        m.attn_bytes_saved_frac = float(by["saved_frac"])
        if self.sc.attn_kernel == "paged":
            m.modeled_attn_bytes_saved = float(by["gather"] - by["paged"])

    def _account_modeled_bytes(self) -> None:
        """Modeled HBM bytes the fused MLP kernel saves vs the unfused
        pipeline at the realized skip fraction, over all decode-tick MLPs
        (the reference's explainability metric, not a measurement):
        relu-family MLPs compare fused vs two_kernel, gated-GLU MLPs the
        GLU kernel vs the unfused three-GEMM pipeline."""
        sp, cfg = self.cfg.sparsity, self.cfg
        if (sp is None or not sp.enabled
                or cfg.family not in ("dense", "vlm", "audio")
                or cfg.mlp_act not in ("relu", "relu2", "silu", "gelu")):
            return
        dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
        glu = cfg.mlp_act in ("silu", "gelu")
        model = (cost_model.glu_mlp_hbm_bytes if glu
                 else cost_model.mlp_hbm_bytes)
        by = model(
            self.sc.batch_slots, cfg.d_model, cfg.d_ff, cfg.d_model,
            block_sparsity=self.metrics.mlp_skip_fraction,
            dtype_bytes=dtype_bytes, block_m=sp.block_m,
        )
        saved = (by["unfused"] if glu else by["two_kernel"]) - by["fused"]
        self.metrics.modeled_hbm_bytes_saved = float(
            saved * cfg.num_layers * self.metrics.ticks)


# ------------------------------------------------------------ async facade
_STREAM_END = object()


class Submission:
    """Handle of one :meth:`AsyncServer.submit`: stream tokens as they
    are produced, or block for the finished :class:`Request`.

    Thread-safe: the engine thread feeds ``_tokens``/``_done`` (numpy
    tokens only); any one client thread consumes :meth:`stream` or
    :meth:`result` (tokens are handed out once)."""

    def __init__(self, request: Request):
        self.request = request
        self._tokens: _queue_mod.Queue = _queue_mod.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def stream(self, timeout: Optional[float] = None) -> Iterator[np.ndarray]:
        """Yield tokens as the engine produces them; returns at EOS or
        budget, raises the request's error if it failed. ``timeout``
        bounds the wait for EACH token (``TimeoutError``)."""
        while True:
            try:
                tok = self._tokens.get(timeout=timeout)
            except _queue_mod.Empty:
                raise TimeoutError(
                    f"request uid={self.request.uid}: no token within "
                    f"{timeout}s") from None
            if tok is _STREAM_END:
                if self._error is not None:
                    raise self._error
                return
            yield tok

    def result(self, timeout: Optional[float] = None) -> Request:
        """Block until the request finishes; returns it with ``out`` and
        ``stats`` filled, or raises its error."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"request uid={self.request.uid} not finished in time")
        if self._error is not None:
            raise self._error
        return self.request


class AsyncServer:
    """Live-queue serving: a background engine thread drains the
    thread-safe admission queue while clients ``submit()`` concurrently.

    * :meth:`submit` validates, enqueues and returns a
      :class:`Submission` (from any thread);
    * :meth:`stream` / ``Submission.stream`` yield tokens as decode
      ticks produce them;
    * :meth:`cancel` fails an outstanding submission with
      :class:`RequestCancelled`;
    * :meth:`drain` blocks until everything submitted so far finished
      and returns the requests completed since the last drain;
    * :meth:`shutdown` (or ``with AsyncServer(...) as srv:``) drains and
      stops the engine thread.

    All model, cache and device state belongs to the one engine thread,
    which makes every kernel launch (on its own current stream); the
    shared surfaces are the queue, the handle table (under ``_lock``),
    the cancel marks and the allocator's atomic reservations. An
    exception escaping the engine's step is engine-fatal: every
    outstanding handle fails with :class:`EngineFatal` and the engine
    stops.
    """

    def __init__(self, cfg: ArchConfig, params, serve_cfg: ServeConfig,
                 *, device="cuda", start: bool = True):
        self._srv = Server(cfg, params, serve_cfg, device=device)
        self._srv.start_engine()
        self._srv.on_token = self._on_token
        self._srv.on_finish = self._on_finish
        self._srv.on_error = self._on_error
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._handles: Dict[int, Submission] = {}
        self._completed: List[Request] = []
        self._failed: List[Request] = []
        self._stop = False
        self._started = False
        self._engine_error: Optional[BaseException] = None
        self._auto_uid = itertools.count()
        self._thread = threading.Thread(
            target=self._engine_loop, name="serve-engine", daemon=True)
        if start:
            self.start()

    # Engine lifecycle -----------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        self._thread.start()

    def _work_pending(self) -> bool:
        return self._srv.queue_depth() > 0 or self._srv.any_active()

    def _engine_loop(self) -> None:
        try:
            if self._srv.device.type == "cuda":
                # The current device is per thread; launch on the
                # server's.
                torch.cuda.set_device(self._srv.device)
            while True:
                with self._wake:
                    while not self._stop and not self._work_pending():
                        self._wake.wait(timeout=0.05)
                    if self._stop:
                        # shutdown(drain=True) already drained;
                        # drain=False fails the outstanding handles after
                        # joining us.
                        return
                self._srv.step()
                with self._wake:
                    self._wake.notify_all()
        except BaseException as e:  # noqa: BLE001 - fail all waiters
            # Whatever escapes step() is ENGINE-fatal: request-scoped
            # faults were contained inside it.
            if isinstance(e, EngineFatal):
                fatal: BaseException = e
            else:
                fatal = EngineFatal(
                    f"engine thread died: {type(e).__name__}: {e}")
                fatal.__cause__ = e
            with self._wake:
                self._engine_error = fatal
                self._stop = True
                for h in self._handles.values():
                    h._error = fatal
                    h._done.set()
                    h._tokens.put(_STREAM_END)
                self._handles.clear()
                self._wake.notify_all()

    # Engine-thread callbacks ---------------------------------------------
    def _on_token(self, req: Request, tok: np.ndarray) -> None:
        with self._lock:
            h = self._handles.get(req.uid)
        if h is not None:
            h._tokens.put(np.asarray(tok))

    def _on_finish(self, req: Request) -> None:
        with self._lock:
            h = self._handles.pop(req.uid, None)
            self._completed.append(req)
        if h is not None:
            h._done.set()
            h._tokens.put(_STREAM_END)

    def _on_error(self, req: Request, err: BaseException) -> None:
        """A request FAILED (cancelled, deadline, contained fault): its
        waiters get the typed error; the engine keeps serving."""
        with self._lock:
            h = self._handles.pop(req.uid, None)
            self._failed.append(req)
        if h is not None:
            h._error = err
            h._done.set()
            h._tokens.put(_STREAM_END)

    # Client surface -------------------------------------------------------
    def submit(self, prompt, max_new: int = 32, *,
               eos_id: Optional[int] = None, priority: float = 0.0,
               deadline_ticks: Optional[float] = None,
               max_ticks: Optional[int] = None,
               uid: Optional[int] = None) -> Submission:
        """Enqueue one request; returns its :class:`Submission`.

        Raises ``ValueError`` at once (nothing enqueued) if the request
        could never be served or its uid is in flight, and
        :class:`ServerOverloaded` (nothing enqueued) when the shed policy
        rejects it. ``priority`` orders admission (higher first, FIFO
        within a class); ``deadline_ticks`` is a per-request TTFT budget;
        ``max_ticks`` a per-request decode budget, past which the handle
        fails with :class:`RequestCancelled`."""
        r = Request(
            uid=next(self._auto_uid) if uid is None else uid,
            prompt=np.asarray(prompt), max_new=max_new, eos_id=eos_id,
            max_ticks=max_ticks)
        self._srv._validate([r])
        h = Submission(r)
        with self._wake:
            if self._stop or self._engine_error is not None:
                raise RuntimeError("AsyncServer is shut down")
            if r.uid in self._handles:
                # Overwriting would orphan the first handle's waiter.
                raise ValueError(f"request uid={r.uid} is already in flight")
            self._handles[r.uid] = h
            try:
                self._srv.enqueue(
                    r, priority=priority, deadline_ticks=deadline_ticks)
            except ServerOverloaded:
                del self._handles[r.uid]  # shed at the door
                raise
            self._wake.notify_all()
        return h

    def cancel(self, handle: Submission) -> bool:
        """Cancel an outstanding submission from any thread. True when it
        was still in flight (its waiters get :class:`RequestCancelled`
        with any partial output on ``handle.request.out``); False when it
        already finished."""
        with self._wake:
            if self._handles.get(handle.uid) is not handle:
                return False
            self._srv.cancel(handle.uid)
            self._wake.notify_all()
        return True

    def stream(self, handle: Submission,
               timeout: Optional[float] = None) -> Iterator[np.ndarray]:
        return handle.stream(timeout=timeout)

    def drain(self, timeout: Optional[float] = None) -> List[Request]:
        """Block until all submitted requests finish; returns the ones
        completed since the last drain, with ``metrics`` finalized.
        Assumes no concurrent submits while draining."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._wake:
            while self._handles or self._work_pending():
                if self._engine_error is not None:
                    raise self._engine_error
                left = None if deadline is None else (
                    deadline - time.perf_counter())
                if left is not None and left <= 0:
                    raise TimeoutError("drain() timed out")
                self._wake.wait(timeout=0.05 if left is None
                                else min(0.05, left))
            if self._engine_error is not None:
                raise self._engine_error
            out, self._completed = self._completed, []
        self._srv.finalize_metrics()
        return out

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop: optionally drain, then stop and join the engine thread;
        with ``drain=False`` the engine stops after its current step and
        unfinished submissions fail with ``RuntimeError``. Idempotent.
        ``timeout`` bounds the WHOLE call: drain and join share one
        deadline."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        if drain and self._started and self._engine_error is None:
            try:
                self.drain(timeout=timeout)
            except TimeoutError:
                pass  # stop anyway
        with self._wake:
            self._stop = True
            # Latch the queue: a submit racing the teardown fails in
            # RequestQueue.push instead of feeding a dead engine.
            self._srv._queue.close()
            self._wake.notify_all()
        if self._started:
            left = (None if deadline is None
                    else max(0.0, deadline - time.perf_counter()))
            self._thread.join(timeout=left)
        with self._wake:
            if self._handles:
                err = RuntimeError("AsyncServer shut down before completion")
                for h in self._handles.values():
                    h._error = err
                    h._done.set()
                    h._tokens.put(_STREAM_END)
                self._handles.clear()

    close = shutdown

    def __enter__(self) -> "AsyncServer":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    @property
    def metrics(self) -> ServeMetrics:
        return self._srv.metrics

    @property
    def failed(self) -> List[Request]:
        """Requests that failed (cancelled, deadline, contained fault)
        since construction; their typed errors sit on ``.error``."""
        with self._lock:
            return list(self._failed)

    @property
    def server(self) -> Server:
        """The wrapped engine (read-only use: metrics, config); do not
        call its stepwise methods while the engine thread runs."""
        return self._srv
