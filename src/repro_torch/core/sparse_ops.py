"""High-level SparCE ops used by the model layers (forward only).

Port of the forward paths of the reference ``repro/core/sparse_ops.py``
that serving runs:

  * :class:`SparsityConfig` -- the technique's config, field for field,
    including the snap of ``expected_sparsity`` to the 1/8 EMA grid;
  * :func:`sparce_matmul` -- a matmul dropping gated tiles:
    ``mode="kernel"`` runs the gated GEMM kernel, ``"reference"`` the
    masked dense oracle, ``"off"`` the plain product;
  * :func:`sparce_mlp` -- the relu-family MLP under the planner's plan:
    ``fused`` runs the fused MLP kernel, ``two_kernel`` the relu-bitmap
    kernel and the gated GEMM kernel, ``dense`` plain matmuls;
  * :func:`sparce_glu_mlp` -- the gated-GLU MLP: ``fused`` runs the
    gated-GLU kernel, ``unfused`` dense gate and up GEMMs then the gated
    GEMM kernel, ``dense`` plain matmuls;
  * :func:`relu_with_bitmap`, :func:`relu2_with_bitmap`,
    :func:`glu_act_with_bitmap` and :func:`gemm_skip_stats`.

The backwards (the reference's ``custom_vjp`` rules) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import sasa, sprf
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype spelling, which keys the planner."""
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """First-class framework config for the paper's technique."""

    enabled: bool = False
    mode: str = "reference"  # 'fused' | 'kernel' | 'reference' | 'off'
    block_m: int = 64
    block_k: int = 128
    block_n: int = 128
    gate_activations: bool = True  # dynamic feature sparsity (FP)
    gate_errors: bool = True  # dynamic error sparsity (BP/WG)
    gate_weights: bool = False  # static pruned-weight sparsity
    weight_sparsity: float = 0.0  # pruning level applied at init when >0
    relufication: bool = False  # swap smooth MLP act for relu^2
    # The reference's Pallas interpret flag, kept for field-for-field
    # config parity. The port has no interpret mode: a CPU tensor takes a
    # kernel's plain version, a CUDA tensor launches the kernel.
    interpret: bool = True
    # Planner inputs (mode='fused'): the measured block-sparsity estimate
    # the MLP plan is built from, and whether the engine may replan.
    expected_sparsity: float = 0.0
    autotune: bool = False
    # Gated-GLU dead-tile threshold: a gate tile with every
    # |act(g)| <= gate_threshold is dead (0.0 = exact all-zero test).
    gate_threshold: float = 0.0

    def __post_init__(self):
        if self.gate_threshold < 0.0:
            raise ValueError(
                f"gate_threshold must be >= 0, got {self.gate_threshold}"
            )
        # Snap expected_sparsity to the SparsityEMA bucket grid, so the
        # engine's replan check (EMA bucket vs this field) can compare
        # equal for an off-grid config value.
        v = min(max(float(self.expected_sparsity), 0.0), 1.0)
        snapped = round(v * sasa.SparsityEMA.BUCKETS) / sasa.SparsityEMA.BUCKETS
        object.__setattr__(self, "expected_sparsity", snapped)

    def block(self) -> Tuple[int, int]:
        return (self.block_m, self.block_k)


def _run_matmul(x, w, lbits, rbits, plan: sasa.SkipPlan, mode: str,
                out_dtype) -> torch.Tensor:
    if mode == "off" or plan.gate == "none":
        return (x.float() @ w.float()).to(out_dtype)
    if mode == "kernel":
        lb = (sprf.TileBitmap(lbits, plan.block_lhs, tuple(x.shape))
              if lbits is not None else None)
        rb = (sprf.TileBitmap(rbits, plan.block_rhs, tuple(w.shape))
              if rbits is not None else None)
        return kops.sparce_gemm(x, w, plan, lhs_bitmap=lb, rhs_bitmap=rb,
                                out_dtype=out_dtype)
    # reference: masked dense (the kernel contract's oracle)
    return kref.sparce_gemm_ref(
        x, w,
        bits_lhs=lbits if plan.gate in ("lhs", "both") else None,
        bits_rhs=rbits if plan.gate in ("rhs", "both") else None,
        block_m=plan.block_m, block_k=plan.block_k, block_n=plan.block_n,
        out_dtype=out_dtype,
    )


def sparce_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: SparsityConfig,
    plan: Optional[sasa.SkipPlan] = None,
    *,
    lhs_bitmap: Optional[sprf.TileBitmap] = None,
    rhs_bitmap: Optional[sprf.TileBitmap] = None,
) -> torch.Tensor:
    """y = x @ w with SparCE tile skipping per ``cfg``/``plan`` (forward).

    x: (M, K) activations (M = flattened batch*seq), w: (K, N) weights.
    """
    if not cfg.enabled or cfg.mode == "off":
        return x @ w
    if plan is None:
        gate = "lhs" if lhs_bitmap is not None else (
            "rhs" if rhs_bitmap is not None else "none")
        if lhs_bitmap is not None and rhs_bitmap is not None:
            gate = "both"
        if gate == "lhs":
            plan = sasa.bitmap_gated_plan(
                x.shape[0], x.shape[1], w.shape[1],
                block_m=cfg.block_m, block_k=cfg.block_k, block_n=cfg.block_n,
            )
        else:
            plan = sasa.SkipPlan(
                gate=gate, variant="gated",
                block_m=cfg.block_m, block_k=cfg.block_k, block_n=cfg.block_n,
            )
    lbits = lhs_bitmap.bits if lhs_bitmap is not None else None
    rbits = rhs_bitmap.bits if rhs_bitmap is not None else None
    return _run_matmul(x, w, lbits, rbits, plan, cfg.mode, x.dtype)


# ------------------------------------------------------------- relu MLP
def two_kernel_mlp(x, w_in, w_out, plan: sasa.MlpPlan, act: str = "relu"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pipeline the planner falls back to: dense up-projection, the
    relu-bitmap kernel, the bitmap-gated down-projection kernel (the
    intermediate makes round trips through device memory that the fused
    kernel avoids). Returns (y, bits)."""
    h = x @ w_in
    a, bmp = kops.relu_with_bitmap(h, (plan.block_m, plan.block_f))
    if act == "relu2":
        a = a * a  # same zero pattern: the bitmap stays valid
    gplan = sasa.bitmap_gated_plan(
        x.shape[0], w_in.shape[1], w_out.shape[1],
        block_m=plan.block_m, block_k=plan.block_f, block_n=plan.block_n,
    )
    y = kops.sparce_gemm(a, w_out, gplan, lhs_bitmap=bmp, out_dtype=x.dtype)
    return y, bmp.bits


def sparce_mlp(
    x: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    act: str,
    cfg: SparsityConfig,
) -> Tuple[torch.Tensor, torch.Tensor, sasa.MlpPlan]:
    """Relu-family MLP forward under the planner's MlpPlan.

    Returns (y, bits, plan); the plan rides along so callers report
    honest skip accounting (the ``dense`` variant computes every tile).
    cfg.block_* pin the tile geometry; the planner chooses the variant.
    """
    m, k = x.shape
    f = w_in.shape[1]
    n = w_out.shape[1]
    plan = sasa.plan_mlp_cached(
        m, k, f, n,
        measured_block_sparsity=cfg.expected_sparsity,
        dtype=dtype_name(x.dtype),
        block_m=cfg.block_m, block_f=cfg.block_k, block_n=cfg.block_n,
    )
    if plan.variant == "fused":
        y, bmp = kops.sparce_mlp_fused(
            x, w_in, w_out, block_m=plan.block_m, block_f=plan.block_f,
            act=act)
        return y, bmp.bits, plan
    if plan.variant == "two_kernel":
        y, bits = two_kernel_mlp(x, w_in, w_out, plan, act)
        return y, bits, plan
    a = torch.clamp_min(x @ w_in, 0.0)
    if act == "relu2":
        a = a * a
    bits = sprf.compute_bitmap(a, (plan.block_m, plan.block_f)).bits
    return a @ w_out, bits, plan


# ------------------------------------------------------------- GLU MLP
def unfused_glu_mlp(x, w_gate, w_in, w_out, plan: sasa.MlpPlan, act: str,
                    tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GLU pipeline the planner falls back to: dense gate and up
    GEMMs, the threshold bitmap at the gate's writeback, then the
    bitmap-gated down-projection kernel (compute skip only: the
    intermediate makes the round trips the fused kernel avoids).
    Returns (y, bits)."""
    g = x @ w_gate
    ga = kref.glu_act_ref(g, act)
    bits = kref.gate_bitmap_ref(ga, (plan.block_m, plan.block_f), tau)
    h = x @ w_in
    a = (ga.float() * h.float()).to(x.dtype)
    bmp = sprf.TileBitmap(bits=bits, block=(plan.block_m, plan.block_f),
                          shape=tuple(a.shape))
    gplan = sasa.bitmap_gated_plan(
        x.shape[0], w_in.shape[1], w_out.shape[1],
        block_m=plan.block_m, block_k=plan.block_f, block_n=plan.block_n,
    )
    y = kops.sparce_gemm(a, w_out, gplan, lhs_bitmap=bmp, out_dtype=x.dtype)
    return y, bits


def sparce_glu_mlp(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    act: str,
    cfg: SparsityConfig,
) -> Tuple[torch.Tensor, torch.Tensor, sasa.MlpPlan]:
    """Gated-GLU MLP forward under the planner's GLU plan.

    Returns (y, bits, plan); the plan rides along so callers report
    honest skip accounting (the ``dense`` variant computes every tile).
    cfg.block_m/block_k pin the gate-tile geometry; cfg.gate_threshold is
    the dead-tile test.
    """
    m, k = x.shape
    f = w_in.shape[1]
    n = w_out.shape[1]
    plan = sasa.plan_glu_mlp_cached(
        m, k, f, n,
        measured_block_sparsity=cfg.expected_sparsity,
        dtype=dtype_name(x.dtype),
        block_m=cfg.block_m, block_f=cfg.block_k, block_n=cfg.block_n,
    )
    tau = float(cfg.gate_threshold)
    if plan.variant == "fused":
        y, bmp = kops.sparce_glu_mlp_fused(
            x, w_gate, w_in, w_out, block_m=plan.block_m,
            block_f=plan.block_f, act=act, tau=tau,
        )
        return y, bmp.bits, plan
    if plan.variant == "unfused":
        y, bits = unfused_glu_mlp(x, w_gate, w_in, w_out, plan, act, tau)
        return y, bits, plan
    # dense fallback: plain GLU; the bitmap rides along (report only).
    g = x @ w_gate
    ga = kref.glu_act_ref(g, act)
    bits = kref.gate_bitmap_ref(ga, (plan.block_m, plan.block_f), tau)
    h = x @ w_in
    a = (ga.float() * h.float()).to(x.dtype)
    return a @ w_out, bits, plan


def glu_act_with_bitmap(
    g: torch.Tensor, act: str, cfg: SparsityConfig
) -> Tuple[torch.Tensor, Optional[sprf.TileBitmap]]:
    """Gate activation (f32-upcast convention) + dead-tile bitmap on the
    flattened-2D view the consuming matmul sees."""
    shape = g.shape
    g2 = g.reshape(-1, shape[-1])
    ga2 = kref.glu_act_ref(g2, act)
    if not cfg.enabled or cfg.mode == "off" or not cfg.gate_activations:
        return ga2.reshape(shape), None
    bits = kref.gate_bitmap_ref(
        ga2, (cfg.block_m, cfg.block_k), float(cfg.gate_threshold))
    return ga2.reshape(shape), sprf.TileBitmap(
        bits=bits, block=(cfg.block_m, cfg.block_k), shape=tuple(g2.shape))


def gemm_skip_stats(bitmap: Optional[sprf.TileBitmap], n: int,
                    block_n: int, device=None) -> torch.Tensor:
    """[skipped_tile_dots, total_tile_dots] (f32) for an lhs-gated
    y = x @ w: each lhs tile bit gates ``ceil(n / block_n)`` tile-dots."""
    if bitmap is None:
        return torch.zeros((2,), dtype=torch.float32, device=device)
    grid_n = -(-n // block_n)
    total = bitmap.bits.numel() * grid_n
    skipped = bitmap.bits.sum().to(torch.float32) * grid_n
    return torch.stack([skipped, torch.full_like(skipped, float(total))])


def relu_with_bitmap(
    x: torch.Tensor, cfg: SparsityConfig
) -> Tuple[torch.Tensor, Optional[sprf.TileBitmap]]:
    """relu + SpRF tile bitmap in one pass (the relu-bitmap kernel with
    ``mode="kernel"``). Accepts (..., features); the bitmap is over the
    flattened-2D view, the layout the consuming matmul sees."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if not cfg.enabled or cfg.mode == "off":
        return torch.clamp_min(x, 0), None
    if cfg.mode == "kernel":
        y2, bmp = kops.relu_with_bitmap(x2, (cfg.block_m, cfg.block_k))
        return y2.reshape(shape), bmp
    y2 = torch.clamp_min(x2, 0)
    return y2.reshape(shape), sprf.compute_bitmap(
        y2, (cfg.block_m, cfg.block_k))


def relu2_with_bitmap(
    x: torch.Tensor, cfg: SparsityConfig
) -> Tuple[torch.Tensor, Optional[sprf.TileBitmap]]:
    """Squared relu: the same zero pattern, so the same bitmap."""
    y, bmp = relu_with_bitmap(x, cfg)
    return y * y, bmp
