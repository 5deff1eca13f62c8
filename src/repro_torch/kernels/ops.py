"""Padded wrappers over the port's kernels (``repro/kernels/ops.py``).

They pad ragged dims to the kernels' block multiples and slice the
results back, with the reference's conventions: padded columns see zero
gate weights, act(0) == 0 and ``|0| <= tau``, so padding can only vote a
tile dead, never live; decode lengths are clamped to the table's reach,
``max_blocks * block_size``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sprf import TileBitmap
from repro_torch.kernels import paged_decode_attn as _pda
from repro_torch.kernels import sparce_glu_mlp as _sgm


def _ceil_to(v: int, q: int) -> int:
    return -(-v // q) * q


def _pad2(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    if tuple(x.shape) == (r, c):
        return x
    return F.pad(x, (0, c - x.shape[1], 0, r - x.shape[0]))


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
