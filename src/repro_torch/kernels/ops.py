"""Padded wrappers over the port's kernels (``repro/kernels/ops.py``).

They pad ragged dims to the kernels' block multiples and slice the
results back, with the reference's conventions: padded columns see zero
gate weights, act(0) == 0 and ``|0| <= tau``, so padding can only vote a
tile dead, never live; padding tiles of a bitmap are all-zero, so their
bits are 1; decode lengths are clamped to the table's reach,
``max_blocks * block_size``. The gated GEMM masks ragged edges in the
kernel, so :func:`sparce_gemm` pads only the bit grids, never the
operands.
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


def _ceil_to(v: int, q: int) -> int:
    return -(-v // q) * q


def _pad2(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    if tuple(x.shape) == (r, c):
        return x
    return F.pad(x, (0, c - x.shape[1], 0, r - x.shape[0]))


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

    ``gate="none"`` or ``variant="dense"`` is the plain f32 product. The
    compacted variant and two-sided gating are not ported yet and
    raise."""
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
    if gate == "both":
        raise NotImplementedError(
            "gate='both' needs the sparce_gemm_gated_both kernel, which is "
            "not ported yet")
    if plan.variant == "compacted":
        raise NotImplementedError(
            "variant='compacted' needs the sparce_gemm_compacted kernel, "
            "which is not ported yet; use variant='gated'")
    if gate not in _sg.GATES:
        raise ValueError(gate)
    bits = fit_bits(lhs_bitmap if gate == "lhs" else rhs_bitmap, gate)
    return _sg.sparce_gemm_gated(
        x.contiguous(), w.contiguous(), bits, block_m=bm, block_k=bk,
        block_n=bn, gate=gate, out_dtype=out_dtype)


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
    accounting is identical. Padding rows and stripes are all-zero after
    the activation: their bits are 1 and their w_out stripes never
    load."""
    m, k = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    pm, pf = _ceil_to(m, block_m), _ceil_to(fdim, block_f)
    y, bits = _sm.sparce_mlp_fused(
        _pad2(x, pm, k).contiguous(),
        _pad2(w_in, k, pf).contiguous(),
        _pad2(w_out, pf, n).contiguous(),
        block_m=block_m, block_f=block_f, act=act, out_dtype=out_dtype,
    )
    return y[:m, :n], TileBitmap(
        bits=bits, block=(block_m, block_f), shape=(m, fdim))


def relu_with_bitmap(x: torch.Tensor, block) -> tuple[torch.Tensor,
                                                      TileBitmap]:
    """Fused relu + SpRF bitmap over a 2-D activation."""
    r, c = x.shape
    br, bc = block
    y, bits = _rb.relu_bitmap(
        _pad2(x, _ceil_to(r, br), _ceil_to(c, bc)).contiguous(),
        block_r=br, block_c=bc)
    return y[:r, :c], TileBitmap(bits=bits, block=(br, bc), shape=(r, c))


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
    produces, so skip accounting is identical."""
    m, k = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    pm, pf = _ceil_to(m, block_m), _ceil_to(fdim, block_f)
    y, bits = _sgm.sparce_glu_mlp_fused(
        _pad2(x, pm, k).contiguous(),
        _pad2(w_gate, k, pf).contiguous(),
        _pad2(w_in, k, pf).contiguous(),
        _pad2(w_out, pf, n).contiguous(),
        block_m=block_m, block_f=block_f, act=act, tau=tau,
        out_dtype=out_dtype,
    )
    return y[:m, :n], TileBitmap(
        bits=bits, block=(block_m, block_f), shape=(m, fdim))


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
