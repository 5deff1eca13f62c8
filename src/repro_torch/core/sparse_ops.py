"""High-level SparCE ops used by the model layers (forward only).

Port of the forward paths of the reference ``repro/core/sparse_ops.py``
that the serving slice runs:

  * :class:`SparsityConfig` -- the technique's config, field for field,
    including the snap of ``expected_sparsity`` to the 1/8 EMA grid;
  * :func:`sparce_glu_mlp` -- the gated-GLU MLP under the planner's
    plan: ``fused`` runs the gated-GLU kernel, ``dense`` plain matmuls;
  * :func:`glu_act_with_bitmap`, :func:`gemm_skip_stats` and
    :func:`sparce_matmul` in ``mode="reference"`` (masked dense).

Not yet ported: the ``sparce_gemm`` kernels (``mode="kernel"``, the
``unfused`` GLU variant), the relu-family fused MLP and every backward.
Those paths raise ``NotImplementedError`` naming what is missing.
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


def sparce_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: SparsityConfig,
    plan: Optional[sasa.SkipPlan] = None,
    *,
    lhs_bitmap: Optional[sprf.TileBitmap] = None,
    rhs_bitmap: Optional[sprf.TileBitmap] = None,
) -> torch.Tensor:
    """y = x @ w with SparCE tile skipping per ``cfg``/``plan``
    (forward; ``mode="reference"`` masked dense, ``"off"`` dense)."""
    if not cfg.enabled or cfg.mode == "off":
        return x @ w
    if cfg.mode == "kernel":
        raise NotImplementedError(
            "sparce_matmul mode='kernel' needs the sparce_gemm kernels, "
            "which are not ported yet; use mode='reference'")
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
    if plan.gate == "none":
        return (x.float() @ w.float()).to(x.dtype)
    lbits = lhs_bitmap.bits if lhs_bitmap is not None else None
    rbits = rhs_bitmap.bits if rhs_bitmap is not None else None
    return kref.sparce_gemm_ref(
        x, w,
        bits_lhs=lbits if plan.gate in ("lhs", "both") else None,
        bits_rhs=rbits if plan.gate in ("rhs", "both") else None,
        block_m=plan.block_m, block_k=plan.block_k, block_n=plan.block_n,
        out_dtype=x.dtype,
    )


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
        raise NotImplementedError(
            "the planner chose the 'unfused' GLU variant, which needs the "
            "sparce_gemm kernels (not ported yet); serve with "
            "autotune=False and an expected_sparsity the fused variant wins")
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
