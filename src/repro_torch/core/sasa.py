"""SASA-table analogue: the GEMM, MLP and network planners (shape-time
static analysis).

Port of the planner parts of the reference ``repro/core/sasa.py``. The
planner's CHOICES are kept exactly as the reference makes them --
including its tile menus and its fast-memory working-set budget, which
were sized for the reference accelerator -- because the skip statistics
depend on them: ``mlp_fwd`` reports zero stats when the plan falls back
to ``variant == "dense"``, and :func:`plan_matmul`'s tiles decide which
tiles of a GEMM count as skips. Re-deriving the choices for this card is
later work; until then the port's plans (and therefore its skip
counters) equal the reference's for the same shapes, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

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


def expected_block_sparsity(
    word_sparsity: float, block_elems: int, cluster_elems: int = 1
) -> float:
    """Probability a whole tile is zero given word-level sparsity.

    Under i.i.d. zeros P(block zero) = p^(block/cluster); clustering
    (zero runs of ``cluster_elems`` words, as in pruned weights) raises
    it.
    """
    if word_sparsity <= 0.0:
        return 0.0
    if word_sparsity >= 1.0:
        return 1.0
    eff = max(1, block_elems // max(1, cluster_elems))
    return float(word_sparsity**eff)


def plan_matmul(
    m: int,
    k: int,
    n: int,
    *,
    lhs_sparsity: float = 0.0,
    rhs_sparsity: float = 0.0,
    lhs_cluster: int = 1,
    rhs_cluster: int = 1,
    dtype: str = "float32",
    block_m: Optional[int] = None,
    block_k: Optional[int] = None,
    block_n: Optional[int] = None,
    min_expected_block_sparsity: float = 0.02,
) -> SkipPlan:
    """Static analysis for one GEMM: operand ordering + tiling + variant.

    The paper's software steps (Section 4.1): find the sparse operand(s),
    gate on the one with the highest block-wise sparsity, emit the skip
    conditions (tile grid + bitmap). Variant: ``dense`` when no operand
    is expected to have skippable tiles, ``compacted`` (walk only the
    nonzero k tiles) at an expected block sparsity >= 0.5, else
    ``gated``.
    """
    sub = _SUBLANE.get(dtype, 8)
    itemsize = 2 if dtype == "bfloat16" else 4

    def ws(bm_, bk_, bn_):
        return (bm_ * bk_ + bk_ * bn_ + bm_ * bn_) * itemsize

    if block_m and block_k and block_n:
        bm, bk, bn = block_m, block_k, block_n
    else:
        # Tile-size search: score = expected skip fraction + a small
        # bonus for larger tiles; tiles past the zero-cluster geometry
        # lose block sparsity.
        bm_menu = [b for b in (sub, 2 * sub, 4 * sub, 8 * sub, 16 * sub, 256)
                   if b <= max(m, sub)]
        bk_menu = [b for b in (128, 256, 512) if b <= max(k, 128)]
        bn_menu = [b for b in (128, 256, 512) if b <= max(n, 128)]

        def pick(menu_a, menu_b, sparsity, cluster, fixed):
            best, best_score = None, -1.0
            for a in menu_a:
                for b in menu_b:
                    if ws(*fixed(a, b)) > _VMEM_BUDGET_BYTES:
                        continue
                    ebs = expected_block_sparsity(sparsity, a * b, cluster)
                    score = ebs + 0.02 * (1 + (a * b).bit_length() / 32.0)
                    if score > best_score:
                        best, best_score = (a, b), score
            return best or (menu_a[0], menu_b[0])

        if lhs_sparsity >= rhs_sparsity:
            bn = block_n or _round_block(n, 256, _MXU_LANE)
            bm, bk = pick(bm_menu, bk_menu, lhs_sparsity, lhs_cluster,
                          lambda a, b: (a, b, bn))
        else:
            bm = block_m or _round_block(m, 256, sub)
            bk, bn = pick(bk_menu, bn_menu, rhs_sparsity, rhs_cluster,
                          lambda a, b: (bm, a, b))
        bm, bk, bn = block_m or bm, block_k or bk, block_n or bn

    # The reference's working-set budget (x tile + w tile + out tile).
    while ws(bm, bk, bn) > _VMEM_BUDGET_BYTES and bk > _MXU_LANE:
        bk //= 2
    while ws(bm, bk, bn) > _VMEM_BUDGET_BYTES and bn > _MXU_LANE:
        bn //= 2
    while ws(bm, bk, bn) > _VMEM_BUDGET_BYTES and bm > sub:
        bm //= 2

    lhs_bs = expected_block_sparsity(lhs_sparsity, bm * bk, lhs_cluster)
    rhs_bs = expected_block_sparsity(rhs_sparsity, bk * bn, rhs_cluster)

    if max(lhs_bs, rhs_bs) < min_expected_block_sparsity:
        gate, ebs = "none", 0.0
    elif (lhs_bs >= min_expected_block_sparsity
          and rhs_bs >= min_expected_block_sparsity):
        gate, ebs = "both", 1.0 - (1.0 - lhs_bs) * (1.0 - rhs_bs)
    elif lhs_bs >= rhs_bs:
        gate, ebs = "lhs", lhs_bs
    else:
        gate, ebs = "rhs", rhs_bs

    if gate == "none":
        variant = "dense"
    elif ebs >= 0.5:
        variant = "compacted"
    else:
        variant = "gated"

    grid_m = -(-m // bm)
    grid_k = -(-k // bk)
    grid_n = -(-n // bn)
    entries = grid_m * grid_k if gate in ("lhs", "both") else (
        grid_k * grid_n if gate == "rhs" else 0
    )
    return SkipPlan(
        gate=gate,
        variant=variant,
        block_m=bm,
        block_k=bk,
        block_n=bn,
        expected_block_sparsity=ebs,
        table_entries=entries,
    )


def dropped_tile_products(plan: SkipPlan, lhs_bits, rhs_bits
                          ) -> Tuple[int, int]:
    """(dropped, total) tile products (i, k, j) of the matmul under
    ``plan`` on these bit grids (lhs ``(gm, gk)``, rhs ``(gk, gn)``, 1 ==
    zero tile): a dense plan drops none, a one-sided gate every product
    of a tile with bit 1, ``gate="both"`` every product either bit
    drops."""
    lb = torch.as_tensor(lhs_bits).bool()
    rb = torch.as_tensor(rhs_bits).bool()
    gm, gk, gn = lb.shape[0], lb.shape[1], rb.shape[1]
    total = gm * gk * gn
    if plan.gate == "none" or plan.variant == "dense":
        return 0, total
    if plan.gate == "lhs":
        return int(lb.sum()) * gn, total
    if plan.gate == "rhs":
        return int(rb.sum()) * gm, total
    return int((lb[:, :, None] | rb[None]).sum()), total


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


def plan_matmul_cached(
    m: int,
    k: int,
    n: int,
    *,
    lhs_sparsity: float = 0.0,
    rhs_sparsity: float = 0.0,
    lhs_cluster: int = 1,
    rhs_cluster: int = 1,
    dtype: str = "float32",
    block_m: Optional[int] = None,
    block_k: Optional[int] = None,
    block_n: Optional[int] = None,
    min_expected_block_sparsity: float = 0.02,
) -> SkipPlan:
    """Memoised :func:`plan_matmul`. Sparsities are bucketed to 1/64
    before keying AND before planning, so a cached plan equals
    ``plan_matmul`` called with the bucketed sparsities."""
    ls, rs = _bucket_sparsity(lhs_sparsity), _bucket_sparsity(rhs_sparsity)
    key = ("plan", m, k, n, dtype, ls, rs, lhs_cluster, rhs_cluster,
           block_m, block_k, block_n, min_expected_block_sparsity)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        _PLAN_CACHE_STATS["misses"] += 1
        plan = plan_matmul(
            m, k, n, lhs_sparsity=ls, rhs_sparsity=rs,
            lhs_cluster=lhs_cluster, rhs_cluster=rhs_cluster, dtype=dtype,
            block_m=block_m, block_k=block_k, block_n=block_n,
            min_expected_block_sparsity=min_expected_block_sparsity,
        )
        _PLAN_CACHE[key] = plan
    else:
        _PLAN_CACHE_STATS["hits"] += 1
    return plan


def plan_cache_stats() -> dict:
    return dict(size=len(_PLAN_CACHE), **_PLAN_CACHE_STATS)


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    _PLAN_CACHE_STATS["hits"] = _PLAN_CACHE_STATS["misses"] = 0


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


def mlp_sample_inputs(m: int, k: int, f: int, n: int, *, block_m: int,
                      measured_block_sparsity: float,
                      dtype: str = "float32", device="cpu"):
    """The autotuner's synthetic (x, w_in, w_out), drawn on ``device``
    from a generator seeded 0: ``|x|`` with zero (block_m, k) row
    clusters at the measured sparsity, so the activated intermediate
    realizes it whatever w_in is, ``|w_in|`` and ``w_out * 0.05`` (the
    reference's recipe; its numbers differ, its geometry does not)."""
    from repro_torch.core import sprf
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    x = sprf.random_sparse(gen, (m, k), measured_block_sparsity, dtype=dt,
                           cluster=(block_m, k)).abs()
    w_in = torch.randn((k, f), generator=gen, device=device).abs().to(dt)
    w_out = torch.randn((f, n), generator=gen, device=device).to(dt) * 0.05
    return x, w_in, w_out


def autotune_mlp_plan(
    m: int, k: int, f: int, n: int, *,
    measured_block_sparsity: float, dtype: str = "float32",
    sample_inputs=None, iters: int = 2, device="cuda",
) -> Tuple[MlpPlan, dict]:
    """Measuring autotuner: time the fused vs two-kernel candidates.

    The model-scored :func:`plan_mlp_cached` is the hot-path default (no
    tensors needed); this entry point additionally RUNS both variants at
    :func:`plan_mlp`'s tiles on ``sample_inputs`` (or
    :func:`mlp_sample_inputs` at the measured sparsity) and returns the
    wall-clock winner and the seconds per call of each, so deployments
    can validate the byte model against real timings. Each candidate is
    called once outside the clock (on the card that call builds its
    kernels), then ``iters`` times, each call ending in a device
    synchronize. Results are cached process-wide like every other plan,
    keyed on the device type, so a CPU timing never answers a CUDA
    caller.
    """
    import time

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    key = ("mlp-tuned", m, k, f, n, dtype,
           _bucket_sparsity(measured_block_sparsity), dev.type)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        _PLAN_CACHE_STATS["hits"] += 1
        return hit

    from repro_torch.core import sparse_ops
    from repro_torch.kernels import ops as kops

    plan = plan_mlp(
        m, k, f, n, measured_block_sparsity=measured_block_sparsity,
        dtype=dtype,
    )
    if sample_inputs is None:
        x, w_in, w_out = mlp_sample_inputs(
            m, k, f, n, block_m=plan.block_m,
            measured_block_sparsity=measured_block_sparsity, dtype=dtype,
            device=dev)
    else:
        x, w_in, w_out = (torch.as_tensor(t, device=dev)
                          for t in sample_inputs)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run_fused():
        kops.sparce_mlp_fused(x, w_in, w_out, block_m=plan.block_m,
                              block_f=plan.block_f)
        sync()

    def run_two_kernel():
        # Same pipeline the fused-mode fallback serves (single impl).
        sparse_ops.two_kernel_mlp(x, w_in, w_out, plan)
        sync()

    timings = {}
    for name, fn in (("fused", run_fused), ("two_kernel", run_two_kernel)):
        fn()  # build / warm
        total = 0.0
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        timings[name] = total / iters
    winner = min(timings, key=timings.get)
    result = (dataclasses.replace(plan, variant=winner), timings)
    _PLAN_CACHE_STATS["misses"] += 1
    _PLAN_CACHE[key] = result
    return result


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


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One GEMM-shaped layer for network-level analysis."""

    name: str
    m: int
    k: int
    n: int
    act_sparsity: float = 0.0  # dynamic (features / errors)
    weight_sparsity: float = 0.0  # static (pruned)
    flops: Optional[int] = None

    def gemm_flops(self) -> int:
        return (self.flops if self.flops is not None
                else 2 * self.m * self.k * self.n)


def analyze_network(
    layers: Sequence[LayerSpec], *, dtype: str = "float32",
    act_cluster: int = 8, weight_cluster: int = 64,
) -> dict:
    """Whole-network static analysis: one SkipPlan per layer plus the
    paper's summary -- the number of distinct (blocks, gate) plans (its
    SASA-entry count) and the redundant-MAC fraction at word and at tile
    granularity (its Fig. 4)."""
    plans = {}
    distinct = set()
    tot_flops = 0
    word_redundant = 0.0
    tile_redundant = 0.0
    for layer in layers:
        plan = plan_matmul(
            layer.m, layer.k, layer.n,
            lhs_sparsity=layer.act_sparsity,
            rhs_sparsity=layer.weight_sparsity,
            lhs_cluster=act_cluster,
            rhs_cluster=weight_cluster,
            dtype=dtype,
        )
        plans[layer.name] = plan
        distinct.add((plan.block_m, plan.block_k, plan.block_n, plan.gate))
        f = layer.gemm_flops()
        tot_flops += f
        word = 1.0 - ((1.0 - layer.act_sparsity)
                      * (1.0 - layer.weight_sparsity))
        word_redundant += f * word
        tile_redundant += f * plan.expected_block_sparsity
    return dict(
        plans=plans,
        distinct_plans=len(distinct),
        total_flops=tot_flops,
        word_redundant_frac=word_redundant / max(1, tot_flops),
        tile_redundant_frac=tile_redundant / max(1, tot_flops),
    )
