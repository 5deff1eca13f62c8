"""Ragged-shape wrappers over the port's kernels (``repro/kernels/ops.py``).

They keep the reference's conventions for ragged dims: padded columns
see zero weights and act(0) == 0, so padding can only vote a tile dead,
never live; padding tiles of a bitmap are all-zero, so their bits are
1; decode lengths are clamped to the table's reach, ``max_blocks *
block_size``. Every kernel masks ragged edges itself, so
:func:`sparce_gemm` pads only the bit grids, and
:func:`sparce_glu_mlp_fused`, :func:`sparce_mlp_fused`,
:func:`relu_with_bitmap` and :func:`relu_bwd_with_bitmap` nothing.
:func:`sparce_gemm` dispatches a plan to its kernel the way the reference does: ``dense`` to a plain
product, lhs to the gated or the compacted kernel, rhs-compacted through
the transpose trick onto the compacted kernel, and ``gate="both"`` to the
two-sided kernel whatever the plan's variant.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sasa import SkipPlan
from repro_torch.core.sprf import TileBitmap
from repro_torch.kernels import paged_decode_attn as _pda
from repro_torch.kernels import relu_bitmap as _rb
from repro_torch.kernels import sparce_gemm as _sg
from repro_torch.kernels import sparce_glu_mlp as _sgm
from repro_torch.kernels import sparce_mlp as _sm


def sparce_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    plan: SkipPlan,
    *,
    lhs_bitmap: Optional[TileBitmap] = None,
    rhs_bitmap: Optional[TileBitmap] = None,
    out_dtype=None,
) -> torch.Tensor:
    """y[M, N] = x[M, K] @ w[K, N] under ``plan``, dropping gated tiles.

    ``gate="none"`` or ``variant="dense"`` is the plain f32 product.
    ``gate="lhs"`` runs the gated or (``variant="compacted"``) the
    compacted kernel over ``lhs_bitmap``; ``"rhs"`` the rhs-gated kernel
    over ``rhs_bitmap``, or for a compacted plan the compacted kernel on
    ``(w.T, x.T, bits.T)`` with blocks (block_n, block_k, block_m),
    transposed back; ``"both"`` the two-sided kernel over both bitmaps,
    also for a compacted plan (the reference routes it so)."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    bm, bk, bn = plan.block_m, plan.block_k, plan.block_n

    def fit_bits(bmp: Optional[TileBitmap], gate: str) -> torch.Tensor:
        if bmp is None:
            raise ValueError(f"gate={gate!r} needs a {gate} bitmap")
        if bmp.block not in ((bm, bk), (bk, bn)):
            raise ValueError(f"bitmap block {bmp.block} does not fit {plan}")
        grid = _sg.bit_grid(m, k, n, block_m=bm, block_k=bk, block_n=bn,
                            gate=gate)
        bits = bmp.bits
        if tuple(bits.shape) != grid:
            # Padding tiles are all-zero => skippable => bit 1.
            bits = F.pad(bits, (0, grid[1] - bits.shape[1],
                                0, grid[0] - bits.shape[0]), value=1)
        return bits

    gate = plan.gate
    if gate == "none" or plan.variant == "dense":
        return (x.float() @ w.float()).to(out_dtype)
    x, w = x.contiguous(), w.contiguous()
    blocks = dict(block_m=bm, block_k=bk, block_n=bn, out_dtype=out_dtype)
    if gate == "both":
        return _sg.sparce_gemm_gated_both(
            x, w, fit_bits(lhs_bitmap, "lhs"), fit_bits(rhs_bitmap, "rhs"),
            **blocks)
    if gate not in _sg.GATES:
        raise ValueError(gate)
    bits = fit_bits(lhs_bitmap if gate == "lhs" else rhs_bitmap, gate)
    if plan.variant != "compacted":
        return _sg.sparce_gemm_gated(x, w, bits, gate=gate, **blocks)
    if gate == "lhs":
        return _sg.sparce_gemm_compacted(x, w, bits, **blocks)
    # y = (w^T @ x^T)^T with the lhs gate on w^T's (block_n, block_k)
    # tiles.
    yt = _sg.sparce_gemm_compacted(
        w.T.contiguous(), x.T.contiguous(), bits.T.contiguous(),
        block_m=bn, block_k=bk, block_n=bm, out_dtype=out_dtype)
    return yt.T.contiguous()


def sparce_mlp_fused(
    x: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    *,
    block_m: int,
    block_f: int,
    act: str = "relu",
    out_dtype=None,
) -> tuple[torch.Tensor, TileBitmap]:
    """Returns (y[M, N], bitmap over act(x @ w_in) at (block_m, block_f)
    granularity) -- the bitmap the two-kernel path produces, so skip
    accounting is identical. Nothing is padded: the kernel takes any M
    and F (rows past M and columns past F vote dead, as the padded
    reference's zeros do)."""
    y, bits = _sm.sparce_mlp_fused(
        x.contiguous(), w_in.contiguous(), w_out.contiguous(),
        block_m=block_m, block_f=block_f, act=act, out_dtype=out_dtype,
    )
    return y, TileBitmap(bits=bits, block=(block_m, block_f),
                         shape=(x.shape[0], w_in.shape[1]))


def relu_with_bitmap(x: torch.Tensor, block) -> tuple[torch.Tensor,
                                                      TileBitmap]:
    """Fused relu + SpRF bitmap over a 2-D activation. Nothing is padded:
    the kernel takes any shape (elements past the edge count as 0, so
    edge tiles get the padded reference's bits)."""
    br, bc = block
    y, bits = _rb.relu_bitmap(x.contiguous(), block_r=br, block_c=bc)
    return y, TileBitmap(bits=bits, block=(br, bc), shape=tuple(x.shape))


def relu_bwd_with_bitmap(x: torch.Tensor, g: torch.Tensor, block
                         ) -> tuple[torch.Tensor, TileBitmap]:
    """Fused relu backward + error bitmap over a 2-D activation: (g *
    (x > 0), bitmap of gx). Nothing is padded: the kernel takes any
    shape (elements past the edge count as 0, so edge tiles get the
    padded reference's bits), and gx comes back dense at x's shape."""
    br, bc = block
    gx, bits = _rb.relu_bwd_bitmap(x.contiguous(), g.contiguous(),
                                   block_r=br, block_c=bc)
    return gx, TileBitmap(bits=bits, block=(br, bc), shape=tuple(x.shape))


def sparce_glu_mlp_fused(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    *,
    block_m: int,
    block_f: int,
    act: str = "silu",
    tau: float = 0.0,
    out_dtype=None,
) -> tuple[torch.Tensor, TileBitmap]:
    """Returns (y[M, N], bitmap over act(x @ w_gate) at (block_m,
    block_f) granularity) -- the grid the unfused gate-threshold path
    produces, so skip accounting is identical. Nothing is padded: the
    kernel takes any M and F (rows past M and columns past F vote dead,
    as the padded reference's zeros do)."""
    y, bits = _sgm.sparce_glu_mlp_fused(
        x.contiguous(), w_gate.contiguous(), w_in.contiguous(),
        w_out.contiguous(), block_m=block_m, block_f=block_f, act=act,
        tau=tau, out_dtype=out_dtype,
    )
    return y, TileBitmap(bits=bits, block=(block_m, block_f),
                         shape=(x.shape[0], w_in.shape[1]))


def paged_decode_attn(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ragged-shape wrapper over the paged GQA decode kernel. Neither the
    table width nor the head dim needs alignment (the kernel loops over
    live blocks only and takes any D), so nothing is padded; lengths
    clamp to the table's reach.

    q: (B, KV, g, D); pools: (nb, bs, KV, D); block_tables: int32
    (B, max_blocks); lengths: int32 (B,) live rows (0 = inactive)."""
    reach = block_tables.shape[1] * k_pool.shape[1]
    return _pda.paged_gqa_decode_attn(
        q.contiguous(), k_pool.contiguous(), v_pool.contiguous(),
        block_tables.to(torch.int32).contiguous(),
        torch.clamp_max(lengths, reach).to(torch.int32).contiguous(),
        scale=scale,
    )


def paged_mla_decode_attn(
    q_lat: torch.Tensor,
    q_rope: torch.Tensor,
    ckv_pool: torch.Tensor,
    kr_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """Ragged-shape wrapper over the paged MLA absorbed-decode kernel:
    nothing is padded (the kernel takes any latent and rope width up to
    its register budget); lengths clamp to the table's reach. Returns
    (B, h, r) latent-space context."""
    reach = block_tables.shape[1] * ckv_pool.shape[1]
    return _pda.paged_mla_decode_attn(
        q_lat.contiguous(), q_rope.contiguous(), ckv_pool.contiguous(),
        kr_pool.contiguous(), block_tables.to(torch.int32).contiguous(),
        torch.clamp_max(lengths, reach).to(torch.int32).contiguous(),
        scale=scale,
    )
