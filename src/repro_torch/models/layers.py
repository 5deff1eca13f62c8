"""Shared layers: RMSNorm, RoPE, MLP (with first-class SparCE gating).

Port of ``repro/models/layers.py``. The MLP is where the paper's
technique lands: a relu-family MLP emits its tile bitmap at the
activation that creates the zeros, a gated-GLU MLP at the gate's
writeback, and either reports ``[skipped, total]`` tile-dot stats of the
down-projection exactly like the reference, so the serving engine's
skip counters equal it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import sparse_ops, sprf
from repro_torch.models import modules as nn


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, dtype, device):
    # The scale is f32 whatever the model dtype, as in the reference.
    return {"scale": nn.ones_init((d,), torch.float32, device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(dt)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- MLP
def mlp_init(rng, d: int, ff: int, act: str, dtype, device):
    """The reference's tree: w_in, w_gate (GLU only), w_out."""
    w_in = nn.dense_init(rng, d, ff, dtype, device)
    p = {"w_in": w_in}
    if act in ("silu", "gelu"):  # gated (GLU) variant
        p["w_gate"] = nn.dense_init(rng, d, ff, dtype, device)
    p["w_out"] = nn.dense_init(rng, ff, d, dtype, device)
    return p


def _activate(h: torch.Tensor, act: str, scfg: sparse_ops.SparsityConfig
              ) -> Tuple[torch.Tensor, Optional[sprf.TileBitmap]]:
    if act == "relu":
        return sparse_ops.relu_with_bitmap(h, scfg)
    if act == "relu2":
        return sparse_ops.relu2_with_bitmap(h, scfg)
    raise ValueError(f"unknown MLP activation {act!r}")


def mlp_fwd(params, x: torch.Tensor, act: str,
            scfg: sparse_ops.SparsityConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d). Returns (y, skip_stats) with skip_stats f32[2] =
    [skipped_tile_dots, total_tile_dots] of the down-projection (zeros
    when the SparCE path is off or the plan computes every tile)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    no_stats = torch.zeros((2,), dtype=torch.float32, device=x.device)
    glu = act in ("silu", "gelu")
    n = params["w_out"].shape[-1]
    if scfg.enabled and scfg.mode == "fused" and scfg.gate_activations:
        # Kernel path: the bitmap at the producer's writeback and the
        # gated down-projection in one kernel (gated GLU: the gate
        # runs first and a dead tile skips its w_in stripe too).
        if glu:
            y, bits, plan = sparse_ops.sparce_glu_mlp(
                x2, params["w_gate"], params["w_in"], params["w_out"], act,
                scfg)
        else:
            y, bits, plan = sparse_ops.sparce_mlp(
                x2, params["w_in"], params["w_out"], act, scfg)
        if plan.variant == "dense":
            # The fallback computes every tile: no realized skips.
            return y.reshape(shape), no_stats
        bmp = sprf.TileBitmap(
            bits=bits, block=(scfg.block_m, scfg.block_k),
            shape=(x2.shape[0], params["w_in"].shape[-1]))
        stats = sparse_ops.gemm_skip_stats(bmp, n, scfg.block_n)
        return y.reshape(shape), stats
    if glu:
        # Gate first, bitmap at its writeback.
        g = x2 @ params["w_gate"]
        ga, bmp = sparse_ops.glu_act_with_bitmap(g, act, scfg)
        a = ga * (x2 @ params["w_in"])
    else:
        a, bmp = _activate(x2 @ params["w_in"], act, scfg)
    if scfg.enabled and bmp is not None and scfg.gate_activations:
        # The bitmap-gated down-projection (masked dense, or the gated
        # GEMM kernel with mode="kernel").
        y = sparse_ops.sparce_matmul(a, params["w_out"], scfg,
                                     lhs_bitmap=bmp)
        stats = sparse_ops.gemm_skip_stats(bmp, n, scfg.block_n)
    else:
        y = a @ params["w_out"]
        stats = no_stats
    return y.reshape(shape), stats
