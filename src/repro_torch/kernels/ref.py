"""Plain PyTorch oracles for the SparCE kernels.

Port of the reference ``repro/kernels/ref.py`` (the parts the serving
path needs). These are the contracts the CUDA kernels are held to:

  * ``sparce_gemm_ref``: y = x @ w with every gated tile's contribution
    dropped (mask, then dense product in f32).
  * ``relu_bitmap_ref``: relu plus the per-tile "no element > 0" bit.
  * ``glu_act_ref`` / ``gate_bitmap_ref`` / ``glu_mlp_ref``: the gated
    GLU with the dead-tile bitmap at the gate's writeback.
  * ``gather_pool_view`` / ``paged_gqa_decode_attn_ref``: decode
    attention over the full gathered view of the paged pool.

Each takes and returns tensors in the reference's layouts and runs on
whatever device its inputs are on.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pad2(x: torch.Tensor, br: int, bc: int) -> torch.Tensor:
    r, c = x.shape
    pr, pc = _ceil_div(r, br) * br, _ceil_div(c, bc) * bc
    if (pr, pc) != (r, c):
        x = F.pad(x, (0, pc - c, 0, pr - r))
    return x


def mask_tiles(x: torch.Tensor, bits: torch.Tensor,
               block: Tuple[int, int]) -> torch.Tensor:
    """Zero out the tiles of ``x`` whose bit is 1."""
    r, c = x.shape
    br, bc = block
    xp = _pad2(x, br, bc)
    pr, pc = xp.shape
    t = xp.reshape(pr // br, br, pc // bc, bc)
    keep = (bits == 0)[:, None, :, None]
    t = torch.where(keep, t, torch.zeros_like(t))
    return t.reshape(pr, pc)[:r, :c]


def sparce_gemm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    bits_lhs: Optional[torch.Tensor] = None,
    bits_rhs: Optional[torch.Tensor] = None,
    block_m: int,
    block_k: int,
    block_n: int,
    out_dtype=None,
) -> torch.Tensor:
    """Oracle: mask gated tiles, then dense matmul in f32 accumulation."""
    if bits_lhs is not None:
        x = mask_tiles(x, bits_lhs, (block_m, block_k))
    if bits_rhs is not None:
        w = mask_tiles(w, bits_rhs, (block_k, block_n))
    out_dtype = out_dtype or x.dtype
    return (x.float() @ w.float()).to(out_dtype)


def relu_bitmap_ref(x: torch.Tensor, block: Tuple[int, int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the relu-bitmap kernel: (relu(x), bits) with bit 1 iff
    no element of the zero-padded tile is > 0."""
    y = torch.clamp_min(x, 0).to(x.dtype)
    br, bc = block
    yp = _pad2(y, br, bc)
    pr, pc = yp.shape
    t = yp.reshape(pr // br, br, pc // bc, bc)
    bits = (~(t > 0).any(dim=3).any(dim=1)).to(torch.int32)
    return y, bits


def act_f32(gf: torch.Tensor, act: str) -> torch.Tensor:
    """The canonical f32 gate activation. ``gelu`` is the tanh
    approximation (the reference framework's default)."""
    if act == "silu":
        return F.silu(gf)
    if act == "gelu":
        return F.gelu(gf, approximate="tanh")
    if act == "relu":
        return torch.clamp_min(gf, 0.0)
    if act == "relu2":
        r = torch.clamp_min(gf, 0.0)
        return r * r
    raise ValueError(act)


def glu_act_ref(g: torch.Tensor, act: str) -> torch.Tensor:
    """GLU gate activation, f32-upcast-then-cast-back: the single
    definition every GLU path shares, so low-precision writebacks round
    identically."""
    return act_f32(g.float(), act).to(g.dtype)


def gate_bitmap_ref(ga: torch.Tensor, block: Tuple[int, int],
                    tau: float) -> torch.Tensor:
    """Per-tile dead bitmap of an activated gate: 1 iff every
    ``|v| <= tau`` (``<=`` so ``tau=0`` is the exact all-zero test).
    Padding tiles are zero-filled and always vote dead."""
    br, bc = block
    gp = _pad2(ga, br, bc)
    pr, pc = gp.shape
    t = gp.reshape(pr // br, br, pc // bc, bc).float()
    return (t.abs() <= tau).all(dim=3).all(dim=1).to(torch.int32)


def glu_mlp_ref(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    *,
    act: str,
    tau: float,
    block_m: int,
    block_f: int,
    out_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the gated-GLU kernel: gate first, threshold at the
    gate's writeback, dead tiles dropped from the intermediate, dense
    down-projection in f32. Returns (y, bits)."""
    g = x @ w_gate
    ga = glu_act_ref(g, act)
    bits = gate_bitmap_ref(ga, (block_m, block_f), tau)
    h = x @ w_in
    a = (ga.float() * h.float()).to(x.dtype)
    a = mask_tiles(a, bits, (block_m, block_f))
    y = a.float() @ w_out.float()
    return y.to(out_dtype or x.dtype), bits


def decode_attn_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: torch.Tensor, *, scale: float | None = None,
) -> torch.Tensor:
    """Decode attention on an already-gathered view: masked softmax over
    live prefixes. q: (B, KV, g, D); k/v: (B, L, KV, D); lengths: (B,)."""
    D = q.shape[-1]
    L = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bkgd,blkd->bkgl", q.float(), k.float()) * scale
    pos = torch.arange(L, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]  # (B, L)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkd->bkgd", p, v.float())
    return o.to(q.dtype)


def gather_pool_view(pool: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
    """(B, max_blocks * bs, ...) gather of each slot's pool blocks in
    table order -- the full-view materialization the paged kernel exists
    to avoid."""
    nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.reshape((nb * bs,) + tuple(pool.shape[2:]))
    tbl = block_tables.to(device=pool.device, dtype=torch.long)
    idx = tbl[:, :, None] * bs + torch.arange(bs, device=pool.device)
    B, mb = tbl.shape
    return flat[idx.reshape(B, mb * bs)]


def paged_gqa_decode_attn_ref(q, k_pool, v_pool, block_tables, lengths,
                              *, scale=None) -> torch.Tensor:
    """Oracle for paged GQA decode: gather the full view, then masked
    softmax."""
    k = gather_pool_view(k_pool, block_tables)
    v = gather_pool_view(v_pool, block_tables)
    return decode_attn_ref(q, k, v, lengths, scale=scale)
