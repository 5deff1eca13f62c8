"""SASA-table analogue: the MLP planner (shape-time static analysis).

Port of the planner parts of the reference ``repro/core/sasa.py``. The
planner's CHOICES are kept exactly as the reference makes them --
including its tile menus and its fast-memory working-set budget, which
were sized for the reference accelerator -- because the skip statistics
depend on them: ``mlp_fwd`` reports zero stats when the plan falls back
to ``variant == "dense"``. Re-deriving the choices for this card is
later work; until then the port's plans (and therefore its skip
counters) equal the reference's for the same shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import cost_model

_MXU_LANE = 128  # the reference's last-dim tile quantum
_SUBLANE = {  # the reference's second-to-last dim granularity per dtype
    "float32": 8,
    "bfloat16": 16,
    "int8": 32,
}
# The reference's per-GEMM fast-memory working-set budget. It gates
# which fused tilings the planner accepts, so it is kept as is.
_VMEM_BUDGET_BYTES = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class SkipPlan:
    """Static skip schedule for one matmul y[M,N] = x[M,K] @ w[K,N]."""

    gate: str  # 'lhs' | 'rhs' | 'both' | 'none'
    variant: str  # 'gated' | 'compacted' | 'dense'
    block_m: int
    block_k: int
    block_n: int
    expected_block_sparsity: float = 0.0
    table_entries: int = 0  # grid positions carrying a skip condition

    @property
    def block_lhs(self) -> Tuple[int, int]:
        return (self.block_m, self.block_k)

    @property
    def block_rhs(self) -> Tuple[int, int]:
        return (self.block_k, self.block_n)


def _round_block(dim: int, target: int, quantum: int) -> int:
    """Largest multiple of ``quantum`` <= target that is sensible for dim."""
    if dim <= quantum:
        return quantum
    b = min(target, dim)
    b = max(quantum, (b // quantum) * quantum)
    return b


# ------------------------------------------------------- process-level cache
# Plans are memoised process-wide keyed on shapes, dtype, the bucketed
# sparsity estimate and the tiling overrides (one SASA-LD per region).
_PLAN_CACHE: dict = {}
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0}
_SPARSITY_BUCKETS = 64  # sparsity quantised to 1/64 for cache keying


def _bucket_sparsity(s: float) -> float:
    """Quantise a sparsity estimate so near-identical values share a plan."""
    s = min(max(float(s), 0.0), 1.0)
    return round(s * _SPARSITY_BUCKETS) / _SPARSITY_BUCKETS


def bitmap_gated_plan(
    m: int, k: int, n: int, *, block_m: int, block_k: int, block_n: int,
) -> SkipPlan:
    """Cached gated-lhs plan for a GEMM whose lhs bitmap already exists."""
    key = ("gated-lhs", m, k, n, block_m, block_k, block_n)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        _PLAN_CACHE_STATS["misses"] += 1
        plan = SkipPlan(
            gate="lhs", variant="gated",
            block_m=block_m, block_k=block_k, block_n=block_n,
            table_entries=-(-m // block_m) * -(-k // block_k),
        )
        _PLAN_CACHE[key] = plan
    else:
        _PLAN_CACHE_STATS["hits"] += 1
    return plan


# ------------------------------------------------------------- planner v2
@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """Skip schedule for one MLP y = act(x[M,K] @ w_in[K,F]) @ w_out[F,N]."""

    variant: str  # 'fused' | 'two_kernel' (GLU: 'unfused') | 'dense'
    block_m: int
    block_f: int  # bitmap granularity over the intermediate's F dim
    block_n: int  # down-projection n-tile (two-kernel path only)
    expected_block_sparsity: float = 0.0
    # Modeled HBM bytes per variant at the measured sparsity, so `why
    # this plan` is answerable from the plan itself.
    modeled_bytes: Tuple[Tuple[str, int], ...] = ()

    def modeled(self) -> dict:
        return dict(self.modeled_bytes)


def _fused_vmem_bytes(bm: int, bf: int, k: int, n: int, itemsize: int) -> int:
    """The reference fused MLP kernel's fast-memory working set."""
    return (
        2 * bm * k * itemsize
        + 2 * k * bf * itemsize
        + 2 * bm * bf * 4
        + 2 * bf * n * itemsize
        + bm * n * 4
        + bm * n * itemsize
    )


def plan_mlp(
    m: int,
    k: int,
    f: int,
    n: int,
    *,
    measured_block_sparsity: float = 0.0,
    dtype: str = "float32",
    block_m: Optional[int] = None,
    block_f: Optional[int] = None,
    block_n: Optional[int] = None,
    min_expected_block_sparsity: float = 0.02,
) -> MlpPlan:
    """Tiling + variant for one relu-family MLP from measured block
    sparsity: variant = argmin of modeled HBM bytes among tilings whose
    fused working set fits the budget."""
    sub = _SUBLANE.get(dtype, 8)
    itemsize = 2 if dtype == "bfloat16" else 4
    s = min(max(float(measured_block_sparsity), 0.0), 1.0)

    bm_menu = [block_m] if block_m else [
        b for b in (sub, 2 * sub, 4 * sub, 8 * sub, 256) if b <= max(m, sub)
    ]
    bf_menu = [block_f] if block_f else [
        b for b in (128, 256, 512) if b <= max(f, 128)
    ]
    bn = block_n or _round_block(n, 256, _MXU_LANE)

    best = None  # (bytes, -tile_area, bm, bf) -> prefer bigger tiles on tie
    for bm in bm_menu:
        for bf in bf_menu:
            if _fused_vmem_bytes(bm, bf, k, n, itemsize) > _VMEM_BUDGET_BYTES:
                continue
            by = cost_model.mlp_hbm_bytes(
                m, k, f, n, block_sparsity=s, dtype_bytes=itemsize,
                block_m=bm,
            )["fused"]
            cand = (by, -(bm * bf), bm, bf)
            if best is None or cand < best:
                best = cand
    fused_ok = best is not None
    if fused_ok:
        _, _, bm, bf = best
    else:
        bm = block_m or _round_block(m, 64, sub)
        bf = block_f or 128

    by = cost_model.mlp_hbm_bytes(
        m, k, f, n, block_sparsity=s, dtype_bytes=itemsize, block_m=bm
    )
    if s < min_expected_block_sparsity:
        variant = "fused" if fused_ok else "dense"
    elif fused_ok and by["fused"] <= by["two_kernel"]:
        variant = "fused"
    else:
        variant = "two_kernel"
    return MlpPlan(
        variant=variant,
        block_m=bm,
        block_f=bf,
        block_n=bn,
        expected_block_sparsity=s,
        modeled_bytes=tuple(
            (kk, vv) for kk, vv in by.items() if isinstance(vv, int)
        ),
    )


def plan_mlp_cached(
    m: int,
    k: int,
    f: int,
    n: int,
    *,
    measured_block_sparsity: float = 0.0,
    dtype: str = "float32",
    block_m: Optional[int] = None,
    block_f: Optional[int] = None,
    block_n: Optional[int] = None,
    min_expected_block_sparsity: float = 0.02,
) -> MlpPlan:
    """Memoised :func:`plan_mlp`; sparsity bucketed to 1/64 first."""
    s = _bucket_sparsity(measured_block_sparsity)
    key = ("mlp", m, k, f, n, dtype, s, block_m, block_f, block_n,
           min_expected_block_sparsity)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        _PLAN_CACHE_STATS["misses"] += 1
        plan = plan_mlp(
            m, k, f, n, measured_block_sparsity=s, dtype=dtype,
            block_m=block_m, block_f=block_f, block_n=block_n,
            min_expected_block_sparsity=min_expected_block_sparsity,
        )
        _PLAN_CACHE[key] = plan
    else:
        _PLAN_CACHE_STATS["hits"] += 1
    return plan


def _glu_fused_vmem_bytes(bm: int, bf: int, k: int, n: int,
                          itemsize: int) -> int:
    """The reference gated-GLU kernel's fast-memory working set."""
    return (
        2 * bm * k * itemsize
        + 2 * k * bf * itemsize
        + 2 * bm * bf * 4
        + 2 * k * bf * itemsize
        + 2 * bf * n * itemsize
        + bm * n * 4
        + bm * n * itemsize
    )


def plan_glu_mlp(
    m: int,
    k: int,
    f: int,
    n: int,
    *,
    measured_block_sparsity: float = 0.0,
    dtype: str = "float32",
    block_m: Optional[int] = None,
    block_f: Optional[int] = None,
    block_n: Optional[int] = None,
    min_expected_block_sparsity: float = 0.02,
) -> MlpPlan:
    """Tiling + variant for one GLU MLP
    y = (act(x @ w_gate) * (x @ w_in)) @ w_out.

    Variants: 'fused' (gated-GLU kernel, two-sided fetch skip),
    'unfused' (gate-thresholded pipeline, compute skip only), 'dense'.
    Fused is not a free win at zero sparsity: the model re-streams the
    live w_in stripes once per row tile, so with many row tiles and low
    measured sparsity the planner prefers a fallback.
    """
    sub = _SUBLANE.get(dtype, 8)
    itemsize = 2 if dtype == "bfloat16" else 4
    s = min(max(float(measured_block_sparsity), 0.0), 1.0)

    bm_menu = [block_m] if block_m else [
        b for b in (sub, 2 * sub, 4 * sub, 8 * sub, 256) if b <= max(m, sub)
    ]
    bf_menu = [block_f] if block_f else [
        b for b in (128, 256, 512) if b <= max(f, 128)
    ]
    bn = block_n or _round_block(n, 256, _MXU_LANE)

    best = None  # (bytes, -tile_area, bm, bf) -> prefer bigger tiles on tie
    for bm in bm_menu:
        for bf in bf_menu:
            if _glu_fused_vmem_bytes(bm, bf, k, n, itemsize) > _VMEM_BUDGET_BYTES:
                continue
            by = cost_model.glu_mlp_hbm_bytes(
                m, k, f, n, block_sparsity=s, dtype_bytes=itemsize,
                block_m=bm,
            )["fused"]
            cand = (by, -(bm * bf), bm, bf)
            if best is None or cand < best:
                best = cand
    fused_ok = best is not None
    if fused_ok:
        _, _, bm, bf = best
    else:
        bm = block_m or _round_block(m, 64, sub)
        bf = block_f or 128

    by = cost_model.glu_mlp_hbm_bytes(
        m, k, f, n, block_sparsity=s, dtype_bytes=itemsize, block_m=bm
    )
    if fused_ok and by["fused"] <= by["unfused"]:
        variant = "fused"
    elif s >= min_expected_block_sparsity:
        variant = "unfused"
    else:
        variant = "dense"
    return MlpPlan(
        variant=variant,
        block_m=bm,
        block_f=bf,
        block_n=bn,
        expected_block_sparsity=s,
        modeled_bytes=tuple(
            (kk, vv) for kk, vv in by.items() if isinstance(vv, int)
        ),
    )


def plan_glu_mlp_cached(
    m: int,
    k: int,
    f: int,
    n: int,
    *,
    measured_block_sparsity: float = 0.0,
    dtype: str = "float32",
    block_m: Optional[int] = None,
    block_f: Optional[int] = None,
    block_n: Optional[int] = None,
    min_expected_block_sparsity: float = 0.02,
) -> MlpPlan:
    """Memoised :func:`plan_glu_mlp`; bucketed like plan_mlp_cached."""
    s = _bucket_sparsity(measured_block_sparsity)
    key = ("glu_mlp", m, k, f, n, dtype, s, block_m, block_f, block_n,
           min_expected_block_sparsity)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        _PLAN_CACHE_STATS["misses"] += 1
        plan = plan_glu_mlp(
            m, k, f, n, measured_block_sparsity=s, dtype=dtype,
            block_m=block_m, block_f=block_f, block_n=block_n,
            min_expected_block_sparsity=min_expected_block_sparsity,
        )
        _PLAN_CACHE[key] = plan
    else:
        _PLAN_CACHE_STATS["hits"] += 1
    return plan


class SparsityEMA:
    """EMA tracker of measured per-layer block sparsity.

    The engine feeds it each decode tick's ``[skipped, total]`` tile-dot
    pair and reads :meth:`bucketed` when (re)planning. The 1/8 bucket is
    coarse so a drifting estimate does not thrash the plans.
    """

    BUCKETS = 8

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.value: Optional[float] = None
        self.updates = 0

    def update(self, skipped: float, total: float) -> float:
        if total > 0:
            frac = min(max(skipped / total, 0.0), 1.0)
            self.value = (
                frac if self.value is None
                else self.alpha * frac + (1 - self.alpha) * self.value
            )
            self.updates += 1
        return self.value or 0.0

    def bucketed(self) -> float:
        v = self.value or 0.0
        return round(v * self.BUCKETS) / self.BUCKETS
