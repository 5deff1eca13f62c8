"""Modeled accounting: the paper's GPP cycle model, the GEMM-saving
model, the serving virtual tick clock and the byte models.

This is the reference package's cost model
(``repro/core/cost_model.py``), copied with its constants unchanged so
that the port's figure rows, admission order, virtual-clock statistics
and modeled byte fields equal the reference's.

Everything here is MODELED, not measured. The GPP model's cycle counts
are the paper's simulated core's; the two rate constants below are the
reference cost model's roofline constants (the accelerator the
reference was written for); they drive the deterministic virtual clock
and the modeled GEMM savings and are not this card's speed. Measured
times of the port live in the
engine's wall-clock fields (``ServeMetrics.*_s``) and in
``chip_smoke.py``'s output.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# ---------------------------------------------------------------- GPP model
# The paper's own setting (its Section 5: an in-order ARMv8 core under
# gem5; Dir-Conv-Scalar and OpenBLAS-SIMD4 baselines). Cycle latencies
# from the paper's gem5 config: L1 D-cache 3 cycles, FP mul/add "3-5
# cycles" (4 taken), int ALU 1. Modeled cycles of that core, not times
# of any device the port runs on.
L1_CYCLES = 3
FP_CYCLES = 4
INT_CYCLES = 1


@dataclasses.dataclass(frozen=True)
class GppConfig:
    simd: int = 1  # SIMD lanes (1 = Dir-Conv-Scalar, 4 = OpenBLAS-SIMD4)
    # Fraction of app time NOT in GEMM-amenable code (paper Fig. 15):
    # scalar: aux ops 1.9%; SIMD: aux 12.2% + GEMM supplementary ops 27%.
    non_amenable_frac: float = 0.019
    gemm_supplementary_frac: float = 0.0
    # Unskippable control instructions per MAC: the cycle model's
    # in-order latency sums use control_per_mac; the instruction counts
    # use instr_control_per_mac (the unrolled BLAS inner loop).
    control_per_mac: float = 2.0
    instr_control_per_mac: float = 1.0
    dense_first_layer_frac: float = 0.143  # paper: AlexNet first layer


# Scalar: the paper's Fig. 6 inner loop -- unskippable = LD INP (3cy) +
# {ADD p0, ADD p1, INC INDEX, BNE} (4x1cy); skippable = LD KER + FMUL +
# FADD.
SCALAR_GPP = GppConfig(simd=1, non_amenable_frac=0.019,
                       gemm_supplementary_frac=0.0, control_per_mac=4.0)
# SIMD4: OpenBLAS sgemm unrolls 16x4; control amortizes over lanes.
SIMD4_GPP = GppConfig(simd=4, non_amenable_frac=0.122,
                      gemm_supplementary_frac=0.27, control_per_mac=1.0)


def gpp_mac_cycles(cfg: GppConfig) -> dict:
    """Cycle breakdown of one (SIMD-wide) MAC group in the inner loop:
    the FP work skips at the shared operand's word rate p, the other
    operand's load only when the whole vector register is zero (p^simd);
    control and the shared-operand load never skip."""
    fp = FP_CYCLES if cfg.simd > 1 else 2 * FP_CYCLES
    return dict(
        fp=fp,  # skips at rate p
        ld_other=L1_CYCLES,  # skips at rate p^simd
        unskippable=L1_CYCLES + INT_CYCLES * cfg.control_per_mac,
    )


def gpp_gemm_time(
    m: int, k: int, n: int, *, sparsity: float, cfg: GppConfig,
    block_sparsity: float | None = None,
) -> dict:
    """Modeled cycles for y[M,N] = x[M,K] @ w[K,N], x sparse.

    ``sparsity`` is word-level on the shared operand; ``block_sparsity``
    overrides BOTH skip rates (the wrong operand ordering: all lanes
    must be zero even for the FP work).
    """
    macs = m * k * n / cfg.simd
    cyc = gpp_mac_cycles(cfg)
    p = sparsity if block_sparsity is None else block_sparsity
    p_reg = (sparsity**cfg.simd) if block_sparsity is None else block_sparsity
    base_per = cyc["fp"] + cyc["ld_other"] + cyc["unskippable"]
    sparce_per = (
        cyc["fp"] * (1.0 - p)
        + cyc["ld_other"] * (1.0 - p_reg)
        + cyc["unskippable"]
    )
    # instruction counts per MAC group (the Fig. 16/17 fractions)
    n_fp = 1 if cfg.simd > 1 else 2
    ctl = cfg.instr_control_per_mac
    n_instr = n_fp + 2 + ctl  # fp + 2 ld + control
    n_exec = n_fp * (1.0 - p) + 1.0 * (1.0 - p_reg) + 1.0 + ctl
    return dict(
        base_cycles=macs * base_per,
        sparce_cycles=macs * sparce_per,
        speedup=base_per / sparce_per,
        instr_frac_executed=n_exec / n_instr,
        dcache_frac_skipped=p_reg / 2.0,  # one of the two loads skips
    )


def gpp_app_time(layer_times: Sequence[dict], *, cfg: GppConfig) -> dict:
    """Application-level reduction with the paper's non-amenable
    fractions; ``layer_times`` are :func:`gpp_gemm_time` dicts of the
    GEMM-amenable layers (a dense first layer with sparsity 0)."""
    gemm_base = sum(t["base_cycles"] for t in layer_times)
    gemm_sparce = sum(t["sparce_cycles"] for t in layer_times)
    other = cfg.non_amenable_frac + cfg.gemm_supplementary_frac
    # Normalize: the GEMM-amenable portion occupies (1 - other).
    base = 1.0
    sparce = other + (1.0 - other) * (gemm_sparce / gemm_base)
    return dict(
        base=base, sparce=sparce,
        app_reduction=1.0 - sparce,
        amenable_frac=1.0 - other,
    )


# ------------------------------------------------------ roofline accounting
# Modeled accounting constants, copied from the reference cost model so
# the virtual clock (and hence admission order) and the modeled GEMM
# savings match it exactly. They are the roofline of the accelerator the
# reference was written for, NOT rates of the device the port runs on.
PEAK_FLOPS_BF16 = 197e12
HBM_BW = 819e9


@dataclasses.dataclass(frozen=True)
class TpuGemmSavings:
    """Modeled base and skipping time of one GEMM (the reference's
    roofline constants; not a measurement)."""

    base_s: float
    sparce_s: float
    flops_skipped_frac: float
    bytes_skipped_frac: float

    @property
    def speedup(self) -> float:
        return (self.base_s / self.sparce_s if self.sparce_s > 0
                else float("inf"))


def tpu_gemm_time(
    m: int, k: int, n: int, *, tile_skip_frac: float,
    dtype_bytes: int = 2, fetch_skip: bool = True, chips: int = 1,
) -> TpuGemmSavings:
    """The reference's roofline model of a gated GEMM at a tile-skip
    fraction: the compute term drops by the skip fraction, the memory
    term (x + w + y once) by the skipped share of w's tile fetches when
    ``fetch_skip``. Kept under the reference's name so its counterpart
    is found; modeled, not measured."""
    flops = 2.0 * m * k * n
    bytes_moved = (m * k + k * n + m * n) * dtype_bytes
    t_c = flops / (PEAK_FLOPS_BF16 * chips)
    t_m = bytes_moved / (HBM_BW * chips)
    base = max(t_c, t_m)
    f_skip = tile_skip_frac
    b_skip = 0.0
    if fetch_skip:
        b_skip = (k * n * dtype_bytes * f_skip) / bytes_moved
    sparce = max(t_c * (1.0 - f_skip), t_m * (1.0 - b_skip))
    return TpuGemmSavings(
        base_s=base, sparce_s=sparce,
        flops_skipped_frac=f_skip, bytes_skipped_frac=b_skip,
    )


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


def model_flops(n_params_active: int, tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D (training); 2*N*D for inference."""
    return 6.0 * n_params_active * tokens


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

    def prefill_flops(self, rows: int) -> float:
        """Modeled FLOPs of a batch=1 prefill over ``rows`` positions
        (``2 * N * rows``); the prefix cache reports its savings in this
        unit."""
        return 2.0 * float(self.n_params) * float(max(rows, 0))


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
