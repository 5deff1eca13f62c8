"""Continuous-batching serving engine, drain mode, over the paged KV pool.

Port of the single-host drain-mode engine of ``repro/runtime/server.py``.
One ``step()`` is:

  1. **admission** -- while a slot is free and the queue head's
     worst-case KV-block commitment fits the pool
     (:meth:`BlockAllocator.try_reserve`), prefill the head alone
     (batch=1, prompt padded up to a power-of-two bucket, logits taken
     at the last REAL position) and scatter its rows into pool blocks;
     its first token comes from the prefill logits.
  2. **decode tick** -- one :func:`model.serving_decode_step` for all
     slots with the live-slot mask. Dead slots' embeddings are zeroed,
     so their MLP gate tiles are all-zero (dead) tiles; with
     ``attn_kernel="paged"`` their KV blocks, and every block past each
     live length, are never read.
  3. **release** -- a slot frees the moment its request hits EOS or its
     ``max_new`` budget: blocks return to the pool, the unused
     commitment is un-reserved, and the ledger is re-checked.

The admission order runs on the reference's deterministic virtual tick
clock (``core/cost_model.py``: modeled costs, not measurements), so on
the same trace and weights the port admits, decodes and releases in the
reference's order and reports the same integer and skip metrics.

Not ported yet (``ServeConfig`` rejects them with NotImplementedError):
the prefix cache, SLO scheduling and ``AsyncServer``/``serve_trace``,
preemption/cancel/deadlines/shedding/fault injection, the SPMD mesh and
the contiguous (``kv_block_size=0``) layout.

Single-threaded: one thread calls ``start_engine``/``step``/``generate``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cost_model, sasa
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_decode_attn import decode_attn_block_counts
from repro_torch.models import model as model_lib
from repro_torch.runtime.metrics import ServeMetrics
from repro_torch.runtime.paging import (
    BlockAllocator, blocks_needed, pick_bucket, resolve_buckets,
)
from repro_torch.runtime.queueing import QueuedRequest, RequestQueue
from repro_torch.runtime.scheduler import Scheduler


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,)
    max_new: int = 32
    eos_id: Optional[int] = None  # overrides ServeConfig.eos_id
    out: Optional[np.ndarray] = None
    # Filled by the engine: ttft_s, latency_s, tokens, decode_ticks,
    # queue_ticks, ttft_ticks, itl_ticks_max.
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
    slo: Optional[Any] = None
    max_queue_depth: Optional[int] = None
    preempt: bool = False
    faults: Optional[Any] = None

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
        unported = {
            "kv_block_size=0 (contiguous layout)": self.kv_block_size == 0,
            "prefix_cache": self.prefix_cache,
            "mesh (SPMD serving)": self.mesh is not None,
            "slo (SLO scheduling)": self.slo is not None,
            "max_queue_depth (load shedding)": self.max_queue_depth is not None,
            "preempt": self.preempt,
            "faults (fault injection)": self.faults is not None,
        }
        missing = [name for name, on in unported.items() if on]
        if missing:
            raise NotImplementedError(
                f"ServeConfig: {', '.join(missing)} not ported yet; the "
                "port serves drain mode over the paged KV pool")


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
    commit: int = 0  # worst-case pool blocks promised to this request
    admit_vt: float = 0.0
    first_vt: float = 0.0
    last_token_vt: float = 0.0
    itl_max: float = 0.0
    released: bool = False


@dataclasses.dataclass
class _EngineState:
    caches: Any
    alloc: BlockAllocator
    tables: np.ndarray
    slots: List[Optional[_Slot]]
    cur_tok: np.ndarray
    completed: List[Request]


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


class Server:
    """Fixed-slot continuous batcher over the paged KV pool.

    ``device`` defaults to ``"cuda"`` and raises on a host without a GPU
    unless ``device="cpu"`` is passed; ``params`` must live on it.
    """

    def __init__(self, cfg: ArchConfig, params, serve_cfg: ServeConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        if serve_cfg.sparsity is not None:
            cfg = dataclasses.replace(cfg, sparsity=serve_cfg.sparsity)
        self.cfg, self.params, self.sc = cfg, params, serve_cfg
        if model_lib.params_device(params).type != self.device.type:
            raise ValueError(
                f"params live on {model_lib.params_device(params)}, the "
                f"server runs on {self.device}")
        if cfg.family not in model_lib.paged_families():
            raise NotImplementedError(
                f"family {cfg.family!r}: the port serves the paged dense "
                "family only")
        self._max_rows = serve_cfg.max_len
        self._max_blocks = blocks_needed(self._max_rows,
                                         serve_cfg.kv_block_size)
        self._pool_usable = (
            serve_cfg.kv_pool_blocks if serve_cfg.kv_pool_blocks is not None
            else serve_cfg.batch_slots * self._max_blocks)
        self._buckets = resolve_buckets(serve_cfg.prefill_buckets,
                                        serve_cfg.max_len)
        self._ema = sasa.SparsityEMA()
        self._rng = np.random.default_rng(serve_cfg.seed)
        # Distinct prefill shapes served: the port runs eagerly, so this
        # is its counterpart of the reference's prefill trace count.
        self._prefill_shapes: set = set()
        self._costs = cost_model.serve_tick_costs(cfg, serve_cfg.batch_slots)
        self._sched = Scheduler(self._costs, None)
        self._queue = RequestQueue()
        self._vt = 0.0
        self._vt_prefill = 0.0
        self._vt_decode = 0.0
        self._ttft_ticks_all: deque = deque(maxlen=100_000)
        self._ttft_s_all: deque = deque(maxlen=100_000)
        self._itl_ticks_all: deque = deque(maxlen=500_000)
        self.admitted_uids: deque = deque(maxlen=100_000)
        self._st: Optional[_EngineState] = None
        self.metrics = ServeMetrics(
            kv_paged=1.0,
            kv_block_size=float(serve_cfg.kv_block_size),
            kv_pool_blocks=float(self._pool_usable),
            attn_kernel_paged=float(serve_cfg.attn_kernel == "paged"),
        )
        self._frag_sum = 0.0
        self._frag_ticks = 0
        self._occ_sum = 0.0
        self._attn_fetched = 0
        self._attn_total = 0

    def _maybe_replan(self) -> None:
        """Re-bucket the measured sparsity into the planner input (only
        with ``SparsityConfig.autotune``). Plans are looked up per call
        from the process cache, so a replan only swaps the config."""
        sp = self.cfg.sparsity
        if sp is None or not (sp.enabled and sp.autotune):
            return
        bucket = self._ema.bucketed()
        if self._ema.updates >= 2 and bucket != sp.expected_sparsity:
            self.cfg = dataclasses.replace(
                self.cfg,
                sparsity=dataclasses.replace(sp, expected_sparsity=bucket))
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
        row prompt+j-1 and the last sampled token is never written."""
        rows0 = int(np.asarray(r.prompt).shape[-1])
        return rows0, rows0 + max(1, r.max_new) - 1

    def _bucket_rows(self, r: Request) -> int:
        S = int(np.asarray(r.prompt).shape[-1])
        return pick_bucket(S, self._buckets) if self._buckets else S

    def _prefill_one(self, r: Request, slot: int, caches,
                     block_ids: List[int]):
        """Prefill one request alone (padded to its bucket, masked tail,
        length advanced by the TRUE length) and scatter it into the pool
        blocks of ``slot``."""
        cfg = self.cfg
        prompt = np.asarray(r.prompt).reshape(-1)
        S = int(prompt.shape[0])
        S_pad = pick_bucket(S, self._buckets) if self._buckets else S
        toks = np.zeros((1, S_pad), np.int64)
        toks[0, :S] = prompt
        dev = self.device
        batch = {
            "tokens": torch.from_numpy(toks).to(dev),
            "advance": torch.tensor([S], dtype=torch.int32, device=dev),
        }
        t0 = time.perf_counter()
        small = model_lib.init_caches(cfg, 1, S_pad, device=dev)
        with torch.no_grad():
            logits, small, aux = model_lib.forward(
                self.params, cfg, batch, small, last_only=True)
        skip = aux["skip"]
        self._prefill_shapes.add(S_pad)
        ids = np.zeros((self._max_blocks,), np.int64)
        ids[: len(block_ids)] = block_ids
        caches = model_lib.insert_slot_paged(
            caches, small, slot, torch.from_numpy(ids).to(dev), S)
        last = logits[0, 0].float().cpu().numpy()  # (V,)
        skip = skip.double().cpu().numpy()
        self.metrics.prefill_s += time.perf_counter() - t0
        self.metrics.prefill_tokens += S
        self.metrics.admitted += 1
        self._count_prefill_skip(skip)
        return last, caches

    def _count_prefill_skip(self, skip: np.ndarray) -> None:
        self.metrics.skipped_tile_dots += float(skip[0])
        self.metrics.total_tile_dots += float(skip[1])
        self.metrics.prefill_skipped_tile_dots += float(skip[0])
        self.metrics.prefill_total_tile_dots += float(skip[1])

    def _finish(self, s: _Slot, t_now: float) -> None:
        r = s.req
        item = s.item
        out = np.array(s.produced[: r.max_new])
        r.out = out
        r.stats = {
            "ttft_s": s.t_first - item.arrival_s,
            "latency_s": t_now - item.arrival_s,
            "tokens": float(len(out)),
            "decode_ticks": float(s.ticks),
            "queue_ticks": s.admit_vt - item.arrival_vt,
            "ttft_ticks": s.first_vt - item.arrival_vt,
            "itl_ticks_max": s.itl_max,
        }
        self.metrics.completed += 1

    def _hit_eos(self, r: Request, tok: np.ndarray) -> bool:
        eos = r.eos_id if r.eos_id is not None else self.sc.eos_id
        if eos is None:
            return False
        return int(tok) == eos

    # -------------------------------------------------------------- engine
    def _validate(self, requests: List[Request]) -> None:
        """Reject requests that can never fit before admitting any."""
        for r in requests:
            prompt = np.asarray(r.prompt)
            if prompt.ndim != 1:
                raise ValueError(
                    f"request uid={r.uid}: prompt must be 1-D token ids, "
                    f"got shape {prompt.shape}")
            need = int(prompt.shape[-1]) + max(1, r.max_new)
            if need > self.sc.max_len:
                raise ValueError(
                    f"request uid={r.uid}: prompt + max_new = {need} "
                    f"tokens do not fit a max_len={self.sc.max_len} cache "
                    "slot; raise ServeConfig.max_len or lower max_new")
            _, worst = self._request_need(r)
            nb = blocks_needed(worst, self.sc.kv_block_size)
            if nb > self._pool_usable:
                raise ValueError(
                    f"request uid={r.uid}: worst case {nb} KV blocks do "
                    f"not fit the {self._pool_usable}-block pool; raise "
                    "ServeConfig.kv_pool_blocks")

    def start_engine(self) -> None:
        """(Re)initialize caches, pool, slots and queue for a run."""
        cfg, sc = self.cfg, self.sc
        B = sc.batch_slots
        caches = model_lib.init_paged_caches(
            cfg, B, self._pool_usable + 1, sc.kv_block_size,
            device=self.device)
        if self._queue.depth():
            raise RuntimeError(
                "start_engine() with requests still queued: drain or "
                "discard the previous run first")
        self._queue = RequestQueue()
        self._vt = 0.0
        self._st = _EngineState(
            caches=caches, alloc=BlockAllocator(self._pool_usable),
            tables=np.zeros((B, self._max_blocks), np.int32),
            slots=[None] * B, cur_tok=np.zeros((B,), np.int64),
            completed=[],
        )

    def enqueue(self, r: Request) -> QueuedRequest:
        """Queue a request, its arrival stamped at the virtual time."""
        return self._queue.push(r, arrival_vt=self._vt)

    def queue_depth(self) -> int:
        return self._queue.depth()

    def any_active(self) -> bool:
        st = self._st
        return st is not None and any(s is not None for s in st.slots)

    def _outstanding_commit(self) -> int:
        """Blocks promised to live slots but not yet allocated."""
        return sum(s.commit - len(s.blocks)
                   for s in self._st.slots if s is not None)

    def _record_first_token(self, s: _Slot) -> None:
        item = s.item
        ttft = s.first_vt - item.arrival_vt
        self._ttft_ticks_all.append(ttft)
        self._ttft_s_all.append(s.t_first - item.arrival_s)
        if ttft > self._sched.ttft_budget(item.deadline_ticks):
            self.metrics.slo_ttft_violations += 1

    def _release(self, i: int) -> None:
        st = self._st
        s = st.slots[i]
        if s is None or s.released:
            raise RuntimeError(f"slot {i} released twice")
        self._finish(s, time.perf_counter())
        st.completed.append(s.req)
        s.released = True
        if s.blocks:
            st.alloc.release(s.blocks)
        # Return the UNUSED tail of the worst-case commitment (raises on
        # a double count).
        st.alloc.unreserve(s.commit - len(s.blocks))
        s.commit = len(s.blocks)
        st.tables[i, :] = 0
        st.slots[i] = None
        st.alloc.check(expect_reserved=self._outstanding_commit())

    def _admission_phase(self) -> int:
        """Admit queue heads into free slots; a head that does not fit
        the pool blocks everything behind it (deterministic order)."""
        st = self._st
        self._sched.begin_round()
        admitted = 0
        for i in range(self.sc.batch_slots):
            if st.slots[i] is not None:
                continue
            res = self._try_admit_head(i)
            if res == "full":
                return admitted
            if res == "admitted":
                admitted += 1
        return admitted

    def _try_admit_head(self, i: int) -> str:
        """One attempt to admit the queue head into free slot ``i``:
        ``"empty"``, ``"full"`` (wait for a release) or ``"admitted"``."""
        st, sc = self._st, self.sc
        item = self._queue.peek()
        if item is None:
            return "empty"
        r = item.req
        rows0, worst = self._request_need(r)
        bs = sc.kv_block_size
        alloc = st.alloc
        commit = blocks_needed(worst, bs)
        if not alloc.can_reserve(commit):
            return "full"
        n_active = sum(1 for s in st.slots if s is not None)
        pt = self._costs.prefill_ticks(self._bucket_rows(r))
        # Drain mode: the scheduler admits greedily (kept for its
        # decision counters and the shared policy surface).
        self._sched.admit_head(
            wait_ticks=self._vt - item.arrival_vt, prefill_ticks=pt,
            n_active=n_active, deadline_ticks=item.deadline_ticks)
        if not alloc.try_reserve(commit):
            return "full"
        block_ids = alloc.alloc(blocks_needed(rows0, bs), reserved=True)
        st.tables[i, : len(block_ids)] = block_ids
        self.metrics.kv_blocks_peak_in_use = max(
            self.metrics.kv_blocks_peak_in_use, float(alloc.in_use))
        self._queue.pop_expected(item)
        t0 = time.perf_counter()
        admit_vt = self._vt
        last_logits, st.caches = self._prefill_one(r, i, st.caches,
                                                   block_ids)
        self._vt += pt
        self._vt_prefill += pt
        first = self._sample(last_logits)
        s = _Slot(
            req=r, item=item, produced=[np.asarray(first)], t_admit=t0,
            t_first=time.perf_counter(), cache_len=rows0, blocks=block_ids,
            commit=commit, admit_vt=admit_vt, first_vt=self._vt,
            last_token_vt=self._vt,
        )
        st.slots[i] = s
        st.cur_tok[i] = first
        self.admitted_uids.append(r.uid)
        self._record_first_token(s)
        if len(s.produced) >= r.max_new or self._hit_eos(
                r, np.asarray(first)):
            self._release(i)  # budget reached / instant EOS: reuse slot
        return "admitted"

    def _decode_tick(self) -> int:
        """One decode tick for all slots (dead slots masked). Returns the
        number of live slots decoded (0 = no-op)."""
        st, sc = self._st, self.sc
        B = sc.batch_slots
        active = np.array([s is not None for s in st.slots], np.float32)
        n_active = int(active.sum())
        if n_active == 0:
            return 0
        # Lazy growth: a slot crossing a block edge claims its next pool
        # block when the write reaches it; the admission commitment
        # guarantees the free list covers it.
        for i, s in enumerate(st.slots):
            if s is None:
                continue
            blk_idx = s.cache_len // sc.kv_block_size
            if blk_idx >= len(s.blocks):
                (new_blk,) = st.alloc.alloc(1, reserved=True)
                s.blocks.append(new_blk)
                st.tables[i, blk_idx] = new_blk
        self.metrics.kv_blocks_peak_in_use = max(
            self.metrics.kv_blocks_peak_in_use, float(st.alloc.in_use))
        if st.alloc.reserved != self._outstanding_commit():
            raise AssertionError(
                f"commitment ledger mismatch: engine expects "
                f"{self._outstanding_commit()} outstanding, allocator "
                f"holds {st.alloc.reserved}")
        used_rows = sum(s.cache_len + 1 for s in st.slots if s is not None)
        cap_rows = sum(len(s.blocks) * sc.kv_block_size
                       for s in st.slots if s is not None)
        if cap_rows:
            self._frag_sum += 1.0 - used_rows / cap_rows
            self._frag_ticks += 1
        self._occ_sum += st.alloc.in_use / max(1, self._pool_usable)
        # Attention fetch accounting in block-table units.
        eff = [0 if s is None else s.cache_len + 1 for s in st.slots]
        fetched, total = decode_attn_block_counts(
            eff, self._max_blocks, sc.kv_block_size)
        self._attn_fetched += fetched
        self._attn_total += total

        step = np.where(active.astype(bool), st.cur_tok, 0)
        dev = self.device
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, st.caches, skip = model_lib.serving_decode_step(
                self.params, self.cfg,
                torch.from_numpy(step[:, None]).to(dev), st.caches,
                torch.from_numpy(active).to(dev),
                torch.from_numpy(st.tables).to(dev),
                attn_kernel=sc.attn_kernel,
            )
            last = logits[:, -1].float().cpu().numpy()  # synchronises
            skip = skip.double().cpu().numpy()
        self.metrics.decode_s += time.perf_counter() - t0
        self.metrics.ticks += 1
        self.metrics.decode_tokens += n_active
        self._vt += 1.0
        self._vt_decode += 1.0
        self.metrics.skipped_tile_dots += float(skip[0])
        self.metrics.total_tile_dots += float(skip[1])
        self._ema.update(float(skip[0]), float(skip[1]))
        self._maybe_replan()

        nxt = self._sample(last)  # (B,)
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
            st.cur_tok[i] = tok
            if len(s.produced) >= s.req.max_new or self._hit_eos(s.req, tok):
                self._release(i)
        return n_active

    def step(self) -> Dict[str, int]:
        """One engine iteration: admission, then one decode tick."""
        if self._st is None:
            raise RuntimeError("start_engine() before step()")
        admitted = self._admission_phase()
        decoded = self._decode_tick()
        return {"admitted": admitted, "decoded": decoded}

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a fixed request list through the engine and drain it."""
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
        return m

    def _account_kv_bytes(self) -> None:
        """Modeled KV reservation: the pool vs the contiguous layout."""
        row_b = cost_model.kv_row_bytes(self.cfg)
        res = cost_model.kv_reservation_bytes(
            self.sc.batch_slots, self._max_rows, row_b,
            pool_blocks=self._pool_usable, block_size=self.sc.kv_block_size)
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
        if (sp is None or not sp.enabled or cfg.family != "dense"
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
