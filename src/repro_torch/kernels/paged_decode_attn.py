"""Paged GQA decode attention straight out of the shared KV pool.

Port of the TPU kernel ``repro/kernels/paged_decode_attn.py:
paged_gqa_decode_attn``. The CUDA kernel (``csrc/paged_decode_attn.cu``)
runs one thread block per (slot, KV head) and loops over the slot's
``ceil(len / block_size)`` live blocks only -- the loop bound replaces
the TPU kernel's index-map clamp, so a table entry past the live prefix,
and the block it names, is never read (the paper's skip-before-fetch).

:func:`paged_gqa_decode_attn` is the one entry point: a CUDA tensor
launches the kernel (and counts the launch in its ``launches``
attribute); a CPU tensor runs :func:`paged_gqa_decode_attn_plain`, the
plain PyTorch version, which also gathers only each slot's live blocks
so the NaN-poison skip-contract tests hold for it on the CPU.

The host-side accounting (:func:`clamped_block_ids`,
:func:`decode_attn_block_counts`, :func:`decode_attn_savings`) is the
reference's, unchanged, so the engine's metrics stay equal to it.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels import _build


# ------------------------------------------------------- host-side contract
def clamped_block_ids(block_tables: np.ndarray, lengths: np.ndarray,
                      block_size: int) -> np.ndarray:
    """The reference TPU kernel's index-map math: the pool block id grid
    step (b, j) maps to, for every j in the table width (dead steps clamp
    onto the slot's last live block; a dead slot onto entry 0)."""
    tbl = np.asarray(block_tables)
    ln = np.asarray(lengths)
    B, max_blocks = tbl.shape
    last = np.maximum(-(-ln // block_size) - 1, 0)  # (B,)
    j = np.arange(max_blocks)[None, :]
    jj = np.minimum(j, last[:, None])
    return np.take_along_axis(tbl, jj, axis=1)


def live_block_ids(block_tables: np.ndarray, lengths: np.ndarray,
                   block_size: int) -> List[np.ndarray]:
    """Host-side mirror of what the CUDA kernel (and the plain version)
    loads: for slot b, exactly the table entries ``[0, ceil(len/bs))``
    in order (capped at the table width) -- nothing for a length-0 slot,
    no entry past the prefix."""
    tbl = np.asarray(block_tables)
    ln = np.maximum(np.asarray(lengths), 0)
    return [tbl[b, : -(-int(ln[b]) // block_size)] for b in range(tbl.shape[0])]


def decode_attn_block_counts(lengths, max_blocks: int,
                             block_size: int) -> tuple[int, int]:
    """(fetched, total) pool blocks one decode tick touches: ``total`` is
    the full ``max_blocks`` view for every slot (the gather path),
    ``fetched`` is ``ceil(len / block_size)`` per slot (0 when dead)."""
    ln = np.asarray(lengths, np.int64)
    fetched = int(np.sum(-(-np.maximum(ln, 0) // block_size)))
    return fetched, int(ln.shape[0]) * int(max_blocks)


def decode_attn_savings(lengths, max_blocks: int, block_size: int) -> float:
    """Fraction of pool-block fetches the paged kernel skips vs the
    full-view gather."""
    fetched, total = decode_attn_block_counts(lengths, max_blocks,
                                              block_size)
    if total == 0:
        return 0.0
    return 1.0 - fetched / total


# ----------------------------------------------------------- plain version
def paged_gqa_decode_attn_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, lengths: torch.Tensor, *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch, reading only live
    blocks: per slot, gather ``table[b, :ceil(len/bs)]`` (capped at the
    table width), masked softmax in f32 (scale after the dot), p rounded
    to the value dtype before the PV product, normaliser floored at
    1e-30; zeros for a dead slot."""
    B, KV, g, D = q.shape
    bs = k_pool.shape[1]
    scale = scale if scale is not None else D ** -0.5
    out = torch.zeros_like(q)
    lens = lengths.tolist()
    max_blocks = block_tables.shape[1]
    for b in range(B):
        n = int(lens[b])
        nblk = min(-(-max(n, 0) // bs), max_blocks)  # the kernel's cap
        if nblk == 0:
            continue
        ids = block_tables[b, :nblk].to(torch.long)
        k = k_pool[ids].reshape(nblk * bs, KV, D)
        v = v_pool[ids].reshape(nblk * bs, KV, D)
        s = torch.einsum("kgd,lkd->kgl", q[b].float(), k.float()) * scale
        pos = torch.arange(nblk * bs, device=q.device)
        s = torch.where(pos < n, s, torch.full_like(s, -1e30))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1).clamp_min(1e-30)[..., None]
        o = torch.einsum("kgl,lkd->kgd", p.to(v.dtype).float(), v.float())
        out[b] = (o / denom).to(q.dtype)
    return out


# ------------------------------------------------------------- CUDA kernel
def paged_gqa_decode_attn(
    q: torch.Tensor,  # (B, KV, g, D) grouped query heads
    k_pool: torch.Tensor,  # (nb, bs, KV, D)
    v_pool: torch.Tensor,  # (nb, bs, KV, D)
    block_tables: torch.Tensor,  # int32 (B, max_blocks), 0 = null block
    lengths: torch.Tensor,  # int32 (B,) live rows incl. this tick's write
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, KV, g, D) attention over each slot's live pool blocks; zeros
    for a slot with ``lengths[b] == 0``. CUDA tensors launch the kernel,
    CPU tensors run the plain version; anything else raises."""
    if q.device.type == "cpu":
        return paged_gqa_decode_attn_plain(
            q, k_pool, v_pool, block_tables, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_decode_attn: unsupported device {q.device}")
    B, KV, g, D = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    max_blocks = block_tables.shape[1]
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _build.DTYPE_IDS or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(
            f"q/k_pool/v_pool must share float32 or bfloat16, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if tuple(k_pool.shape) != (nb, bs, KV, D) \
            or tuple(v_pool.shape) != (nb, bs, KV, D) \
            or tuple(block_tables.shape) != (B, max_blocks) \
            or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("paged_decode_attn", "paged_gqa_decode_attn",
                         [p, p, p, p, p, p, i, i, i, i, i, i,
                          ctypes.c_float, i, p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, KV, g, D, bs, max_blocks, float(scale),
        _build.DTYPE_IDS[q.dtype], stream)
    paged_gqa_decode_attn.launches += 1
    if err != 0:
        raise RuntimeError(
            f"paged_gqa_decode_attn launch failed: cudaError {err}")
    return out


paged_gqa_decode_attn.launches = 0
