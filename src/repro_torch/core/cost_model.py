"""Modeled serving accounting: the virtual tick clock and byte models.

This is the serving subset of the reference package's cost model
(``repro/core/cost_model.py``), copied with its constants unchanged so
that the port's admission order, virtual-clock statistics and modeled
byte fields equal the reference's on the same trace.

Everything here is MODELED, not measured. The two rate constants below
are the reference cost model's roofline constants (the accelerator the
reference was written for); they drive the deterministic virtual clock
and are not this card's speed. Measured times of the port live in the
engine's wall-clock fields (``ServeMetrics.*_s``) and in
``chip_smoke.py``'s output.
"""
from __future__ import annotations

import dataclasses

# Modeled accounting constants, copied from the reference cost model so
# the virtual clock (and hence admission order) matches it exactly.
# They are NOT rates of the device the port runs on.
PEAK_FLOPS_BF16 = 197e12
HBM_BW = 819e9


def mlp_hbm_bytes(
    m: int, k: int, f: int, n: int, *, block_sparsity: float,
    dtype_bytes: int = 4, block_m: int = 64,
) -> dict:
    """Modeled HBM traffic of one 2-matrix MLP y = act(x @ w_in) @ w_out.

    Per variant (bytes, per forward call): ``dense`` (unfused: the
    intermediate makes one round trip), ``two_kernel`` (up-GEMM, relu +
    bitmap pass, gated down-GEMM: three round trips) and ``fused`` (the
    intermediate never leaves the chip and a zero tile's w_out stripe is
    never fetched). Row-tile sweeps re-fetch w_out in every variant, so
    ``nm`` multiplies the w_out stream.
    """
    s = min(max(float(block_sparsity), 0.0), 1.0)
    nm = -(-m // block_m)
    x_b = m * k * dtype_bytes
    win_b = k * f * dtype_bytes
    wout_b = nm * f * n * dtype_bytes
    inter_b = m * f * dtype_bytes
    y_b = m * n * dtype_bytes
    dense = x_b + win_b + 2 * inter_b + wout_b + y_b
    two_kernel = x_b + win_b + 4 * inter_b + wout_b + y_b
    fused = x_b + win_b + wout_b * (1.0 - s) + y_b
    return {
        "dense": int(dense),
        "two_kernel": int(two_kernel),
        "fused": int(round(fused)),
        "fused_saved_frac_vs_two_kernel": 1.0 - fused / two_kernel,
        "intermediate_bytes": int(inter_b),
    }


def glu_mlp_hbm_bytes(
    m: int, k: int, f: int, n: int, *, block_sparsity: float,
    dtype_bytes: int = 4, block_m: int = 64,
) -> dict:
    """Modeled HBM traffic of one 3-matrix GLU MLP
    y = (act(x @ w_gate) * (x @ w_in)) @ w_out.

    Per variant (bytes, per forward call): ``dense`` (the gated
    intermediate makes one round trip), ``unfused`` (g, h and a each
    round-trip: six round trips, compute skip only) and ``fused`` (no
    intermediate traffic; a dead tile skips its w_in AND w_out stripes,
    both re-fetched per row-tile sweep, so ``nm`` multiplies both gated
    streams). ``block_sparsity`` is the fraction of dead
    (block_m, block_f) gate tiles.
    """
    s = min(max(float(block_sparsity), 0.0), 1.0)
    nm = -(-m // block_m)
    x_b = m * k * dtype_bytes
    wgate_b = k * f * dtype_bytes
    win_b = k * f * dtype_bytes
    win_sweep_b = nm * k * f * dtype_bytes
    wout_sweep_b = nm * f * n * dtype_bytes
    inter_b = m * f * dtype_bytes
    y_b = m * n * dtype_bytes
    dense = x_b + wgate_b + win_b + 2 * inter_b + wout_sweep_b + y_b
    unfused = x_b + wgate_b + win_b + 6 * inter_b + wout_sweep_b + y_b
    fused = (
        x_b + wgate_b + (win_sweep_b + wout_sweep_b) * (1.0 - s) + y_b
    )
    return {
        "dense": int(dense),
        "unfused": int(unfused),
        "fused": int(round(fused)),
        "fused_saved_frac_vs_unfused": 1.0 - fused / unfused,
        "intermediate_bytes": int(inter_b),
    }


# ------------------------------------------------------------- KV-bytes model
def kv_row_bytes(cfg) -> int:
    """Bytes ONE cached token row costs across all attention layers
    (GQA: k + v per kv-head). ``cfg`` is duck-typed."""
    dtype_bytes = 2 if getattr(cfg, "dtype", "bfloat16") == "bfloat16" else 4
    mla = getattr(cfg, "mla", None)
    if mla is not None:
        per_layer = (mla.kv_lora_rank + mla.qk_rope_dim) * dtype_bytes
    else:
        per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * dtype_bytes
    return per_layer * cfg.num_layers


def decode_attn_hbm_bytes(
    *, blocks_fetched: int, blocks_total: int, block_size: int,
    row_bytes: int,
) -> dict:
    """Modeled decode-attention KV traffic in pool-block units: the
    full-view gather (every table entry of every slot) vs the paged
    kernel (only ``ceil(len/block_size)`` live blocks per live slot)."""
    gather = int(blocks_total) * block_size * row_bytes
    paged = int(blocks_fetched) * block_size * row_bytes
    return {
        "gather": int(gather),
        "paged": int(paged),
        "saved_frac": 1.0 - paged / max(gather, 1),
    }


def kv_reservation_bytes(
    batch_slots: int, max_rows: int, row_bytes: int, *,
    pool_blocks: int | None = None, block_size: int = 0,
) -> dict:
    """Reserved KV bytes: contiguous per-slot layout vs a shared pool."""
    contiguous = batch_slots * max_rows * row_bytes
    if pool_blocks is None or block_size <= 0:
        paged = contiguous
    else:
        paged = pool_blocks * block_size * row_bytes
    return {
        "contiguous": int(contiguous),
        "paged": int(paged),
        "saved_frac": 1.0 - paged / max(contiguous, 1),
    }


# ----------------------------------------------------------- tick-time model
@dataclasses.dataclass(frozen=True)
class TickCosts:
    """Deterministic engine-step cost estimates for the scheduler.

    The unit of account is ONE DECODE TICK; a prefill of ``rows`` prompt
    rows costs ``prefill_ticks(rows)`` tick-equivalents. The virtual
    clock advances by these amounts, so every scheduling quantity is a
    pure function of the arrival trace and the model shapes.
    ``tick_seconds`` is the MODELED seconds of one tick under the
    reference constants above, not a measurement on this card.
    """

    decode_tick_s: float
    n_params: int
    dtype_bytes: int

    @property
    def tick_seconds(self) -> float:
        return self.decode_tick_s

    def prefill_s(self, rows: int) -> float:
        """Modeled seconds for a batch=1 prefill over ``rows`` positions."""
        return forward_roofline_s(
            self.n_params, rows, dtype_bytes=self.dtype_bytes)

    def prefill_ticks(self, rows: int) -> float:
        """Prefill cost in decode-tick units (>= a small floor)."""
        return max(self.prefill_s(rows) / self.decode_tick_s, 1e-3)


def forward_roofline_s(
    n_params: int, tokens: int, *, dtype_bytes: int = 2, chips: int = 1,
) -> float:
    """Modeled seconds of one forward over ``tokens`` positions: the
    larger of ``2 * N * tokens`` FLOPs and every parameter streamed once,
    under the modeled constants above."""
    flops = 2.0 * float(n_params) * float(tokens)
    bytes_moved = float(n_params) * dtype_bytes
    return max(flops / (PEAK_FLOPS_BF16 * chips),
               bytes_moved / (HBM_BW * chips))


def serve_tick_costs(cfg, batch_slots: int) -> TickCosts:
    """The scheduler's :class:`TickCosts` for an ArchConfig: one decode
    tick processes ``batch_slots`` tokens (dead slots ride through the
    step, so the cost is the static batch)."""
    n = int(cfg.n_params())
    dtype_bytes = 2 if getattr(cfg, "dtype", "bfloat16") == "bfloat16" else 4
    decode_s = forward_roofline_s(
        n, max(1, batch_slots), dtype_bytes=dtype_bytes)
    return TickCosts(decode_tick_s=decode_s, n_params=n,
                     dtype_bytes=dtype_bytes)
