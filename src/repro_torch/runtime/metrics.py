"""Typed serving metrics: the engine's one stable observability surface.

:class:`ServeMetrics` replaces the stringly-typed ``Server.metrics``
dict of earlier engines. Every field below is documented, default-zero, and
stable across releases -- benches, CI gates and the launcher printout
consume attributes (typo'd names fail at import/attribute time instead
of silently reading 0.0), and :meth:`ServeMetrics.as_dict` feeds the
JSON artifact/baseline path. Dict-style reads (``m["ticks"]``,
``m.get(...)``, ``"ticks" in m``) are kept as thin shims over
``getattr`` so existing harness assertions keep working; writes go
through attributes only.

Units: token/tick/block counters are counts; ``*_s`` fields are wall
seconds; ``*_ticks_*`` fields are virtual decode-tick units (the
deterministic clock CI gates run on); ``*_bytes*`` fields are modeled
HBM bytes from ``core/cost_model.py``; fractions are in [0, 1].
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class ServeMetrics:
    """Engine counters and modeled statistics for one :class:`Server`.

    Grouped like the engine itself: token/tick throughput, SparCE skip
    accounting, paged-KV pool telemetry, decode-attention fetch model,
    queue/SLO latency statistics, and the prefix-cache sharing stats.
    """

    # --- throughput -------------------------------------------------------
    prefill_tokens: float = 0.0  # real prompt tokens prefilled
    decode_tokens: float = 0.0  # live-slot tokens across decode ticks
    ticks: float = 0.0  # decode ticks executed
    admitted: float = 0.0  # requests prefilled into a slot
    completed: float = 0.0  # requests finished (EOS or budget)
    prefill_s: float = 0.0  # wall seconds in prefill calls
    decode_s: float = 0.0  # wall seconds in decode ticks
    replans: float = 0.0  # SASA autotune replans

    # --- SparCE skip accounting ------------------------------------------
    skipped_tile_dots: float = 0.0  # MLP tile-dots skipped (all phases)
    total_tile_dots: float = 0.0  # MLP tile-dots issued (all phases)
    mlp_skip_fraction: float = 0.0  # skipped / total
    # Prefill-phase slice of the two counters above: with the prefix
    # cache on, suffix-only prefills legitimately run FEWER prefill
    # GEMMs, so parity checks compare the DECODE slice (total - prefill).
    prefill_skipped_tile_dots: float = 0.0
    prefill_total_tile_dots: float = 0.0
    modeled_hbm_bytes_saved: float = 0.0  # fused-MLP HBM model

    # --- paged-KV pool ----------------------------------------------------
    kv_paged: float = 0.0  # 1.0 when the paged layout is live
    kv_block_size: float = 0.0
    kv_pool_blocks: float = 0.0  # usable blocks (null excluded)
    kv_blocks_peak_in_use: float = 0.0
    kv_pool_peak_occupancy: float = 0.0
    kv_internal_frag: float = 0.0  # mean unused-tail fraction
    kv_bytes_reserved: float = 0.0
    kv_bytes_reserved_contiguous: float = 0.0
    kv_bytes_saved_frac: float = 0.0
    kv_reserved_bytes_per_token: float = 0.0
    kv_pool_mean_occupancy: float = 0.0
    prefill_traces: float = 0.0  # distinct prefill bucket shapes served

    # --- decode-attention fetch model ------------------------------------
    attn_kernel_paged: float = 0.0  # 1.0 when the paged kernel serves
    attn_blocks_fetched: float = 0.0
    attn_blocks_total: float = 0.0
    attn_block_skip_fraction: float = 0.0
    attn_bytes_gather: float = 0.0
    attn_bytes_paged: float = 0.0
    attn_bytes_saved_frac: float = 0.0
    modeled_attn_bytes_saved: float = 0.0

    # --- queue / SLO latency (virtual-tick clock) ------------------------
    queue_depth: float = 0.0
    queue_depth_peak: float = 0.0
    ttft_ticks_p50: float = 0.0
    ttft_ticks_p95: float = 0.0
    ttft_ticks_p99: float = 0.0
    itl_ticks_p50: float = 0.0
    itl_ticks_p95: float = 0.0
    itl_ticks_p99: float = 0.0
    ttft_s_p50: float = 0.0
    ttft_s_p99: float = 0.0
    slo_ttft_violations: float = 0.0
    slo_itl_violations: float = 0.0
    sched_admitted: float = 0.0
    sched_deferred: float = 0.0
    sched_forced: float = 0.0
    prefill_tick_share: float = 0.0
    decode_tick_share: float = 0.0

    # --- robustness: preemption / shedding / cancellation / faults -------
    # Preempt/requeue (ServeConfig.preempt): running slots evicted by
    # the scheduler's reclaim policy to fund a forced-TTFT admission,
    # and the requeues that restore them (suffix-only re-prefill when
    # the prefix cache kept their written blocks). requeues == preemptions
    # unless a preempted request is later shed/cancelled in the queue.
    preemptions: float = 0.0
    requeues: float = 0.0
    # Ticks of re-prefill work actually paid to restore preempted
    # requests -- the realized "squash penalty" the reclaim cost model
    # traded against the victim's natural release.
    preempt_restore_ticks: float = 0.0
    shed_requests: float = 0.0  # pushes rejected by the shed policy
    cancelled: float = 0.0  # cancel() + max_ticks decode deadlines
    failed_requests: float = 0.0  # request-scoped faults contained
    faults_injected: float = 0.0  # FaultPlan events fired
    faults_recovered: float = 0.0  # contained or retried-through

    # --- SPMD serving mesh ------------------------------------------------
    # Axis sizes of the (data, model) serving mesh (0.0 = single-host).
    # Skip/fetch counters above are psum'd across every shard before they
    # land here, so the CI gates hold unchanged on a mesh (aggregated
    # SpRF telemetry, per the paper's per-core skip state).
    mesh_data: float = 0.0
    mesh_model: float = 0.0

    # --- prefix cache (block sharing + CoW) ------------------------------
    prefix_cache_enabled: float = 0.0  # 1.0 when ServeConfig.prefix_cache
    prefix_lookups: float = 0.0  # admissions that consulted the index
    prefix_hits: float = 0.0  # admissions with >= 1 matched block
    prefix_hit_rate: float = 0.0  # hits / lookups
    prefix_matched_tokens: float = 0.0  # prompt tokens served from cache
    prefix_blocks_shared: float = 0.0  # read-only block mappings created
    prefix_cow_forks: float = 0.0  # copy-on-write block forks
    prefix_evicted_blocks: float = 0.0  # LRU evictions under pressure
    prefix_cache_blocks: float = 0.0  # registered blocks at finalize
    # Modeled prefill work a hit kept off the engine: full-prompt bucket
    # cost minus the suffix bucket that actually ran, summed over
    # admissions (ticks via TickCosts.prefill_ticks, FLOPs via
    # TickCosts.prefill_flops). The _nocache total covers EVERY
    # admission while the cache is on, so saved_frac is a run-level
    # fraction, not a per-hit one.
    prefill_ticks_nocache: float = 0.0
    prefill_ticks_saved: float = 0.0
    prefill_ticks_saved_frac: float = 0.0
    prefill_flops_saved: float = 0.0

    # --- typed-API surface -----------------------------------------------
    def as_dict(self) -> Dict[str, float]:
        """Plain ``{field: float}`` for JSON artifacts and baselines."""
        return {
            f.name: float(getattr(self, f.name))
            for f in dataclasses.fields(self)
        }

    # Dict-style READ shims (back-compat for harness assertions). There
    # is deliberately no __setitem__: writers must use attributes.
    def __getitem__(self, key: str) -> float:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default: Optional[float] = None):
        return getattr(self, key, default)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)
