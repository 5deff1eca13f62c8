"""Paged decode attention straight out of the shared KV pool.

Ports of the TPU kernels ``repro/kernels/paged_decode_attn.py:
paged_gqa_decode_attn`` and ``paged_mla_decode_attn``. Both CUDA kernels
run on the tensor cores over chunks of each slot's block table, the
chunks fixed by the shapes: the GQA kernel (``csrc/paged_decode_attn.cu``)
one thread block per (group of up to 4 KV heads, slot, chunk)
(:func:`gqa_chunks`, :func:`gqa_grid`), the MLA kernel
(``csrc/paged_mla_decode_attn.cu``) one per (chunk, group of 32 heads,
slot) (:func:`mla_chunks`). A chunk at or past the slot's live count
reads nothing (:func:`gqa_chunk_walk` and :func:`mla_chunk_walk` mirror
the reads on the host); a slot's live chunks are merged in ascending
order from f32 scratch -- by the last GQA block of the slot to arrive,
by a second launch for MLA. The loops' bounds replace the TPU kernel's
index-map clamp, so a table entry past the live prefix, and the block it
names, is never read (the paper's skip-before-fetch).

:func:`paged_gqa_decode_attn` and :func:`paged_mla_decode_attn` are the
entry points: a CUDA tensor launches the kernel (and counts the launch
in the function's ``launches`` attribute); a CPU tensor runs the plain
PyTorch version (``*_plain``), which also gathers only each slot's live
blocks so the NaN-poison skip-contract tests hold for it on the CPU.

The host-side accounting (:func:`clamped_block_ids`,
:func:`decode_attn_block_counts`, :func:`decode_attn_savings`) is the
reference's, unchanged, so the engine's metrics stay equal to it.
"""
from __future__ import annotations

import ctypes
import threading
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


def live_block_count(length: int, block_size: int, max_blocks: int) -> int:
    """Pool blocks the kernels (and plain versions) read for one slot:
    ``ceil(length / block_size)``, 0 for a dead slot, capped at the
    table width."""
    return min(-(-max(int(length), 0) // block_size), max_blocks)


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
        nblk = live_block_count(n, bs, max_blocks)
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
# Shapes the GQA kernel takes: query rows of a KV head (the MMA's N) and
# the head dim (its O accumulators in registers).
GQA_MAX_GROUP = 8
GQA_MAX_HEAD_DIM = 128
# KV heads a thread block covers (one warp each); the CTAs its grid aims
# at when every chunk is live (one per H100 SM: 2 blocks a chunk at
# smollm's decode shape, of 1, 2 and 4 the fastest by tools/gqa_probe.py
# over the trace's lengths and the full table together; a 16-row step of
# a chunk costs more than merging one more chunk); a chunk's table
# entries sit in the kernel's shared memory.
GQA_HEADS_PER_CTA = 4
GQA_CTA_AIM = 132
GQA_MAX_CHUNK_ENTRIES = 256


def gqa_head_groups(kv_heads: int) -> tuple[int, int]:
    """(groups, heads per group): the KV heads split as evenly as
    possible into groups of at most :data:`GQA_HEADS_PER_CTA`."""
    groups = -(-kv_heads // GQA_HEADS_PER_CTA)
    return groups, -(-kv_heads // groups)


def gqa_chunks(batch: int, kv_heads: int, max_blocks: int,
               block_size: int) -> tuple[int, int]:
    """(S, E): the GQA kernel cuts each slot's table into S chunks of E
    entries, S * E >= max_blocks. A function of the shapes only -- never
    of the lengths -- so the launch needs no host read and can be
    captured in a CUDA graph."""
    del block_size  # a chunk's rows stream through a ring: any bs
    if max_blocks <= 0:
        return 1, 1
    groups, _ = gqa_head_groups(kv_heads)
    s = max(1, -(-GQA_CTA_AIM // (batch * groups)))
    e = min(max(1, -(-max_blocks // s)), GQA_MAX_CHUNK_ENTRIES)
    return -(-max_blocks // e), e


def gqa_grid(batch: int, kv_heads: int, max_blocks: int,
             block_size: int) -> dict:
    """The GQA kernel's launch: chunks per slot, table entries per chunk,
    head groups, warps (KV heads) per CTA, and CTAs (head groups x slots
    x chunks)."""
    s, e = gqa_chunks(batch, kv_heads, max_blocks, block_size)
    groups, hpc = gqa_head_groups(kv_heads)
    return dict(chunks=s, entries=e, head_groups=groups, warps=hpc,
                ctas=groups * batch * s)


def gqa_scratch_shape(batch: int, kv_heads: int, group: int, head_dim: int,
                      max_blocks: int, block_size: int) -> tuple:
    """The f32 scratch the GQA kernel writes a chunk's (O, m, l) to:
    (slots, chunks, KV heads, query rows, head_dim rounded up to 8 plus
    8: O, then m and l, in rows of whole 32-byte groups). A function of
    the shapes only."""
    s, _ = gqa_chunks(batch, kv_heads, max_blocks, block_size)
    return (batch, s, kv_heads, group, -(-head_dim // 8) * 8 + 8)


def gqa_chunk_walk(block_tables: np.ndarray, lengths: np.ndarray,
                   block_size: int,
                   kv_heads: int) -> List[List[np.ndarray]]:
    """Host-side mirror of the table entries the GQA kernel reads: for
    slot b and chunk c of :func:`gqa_chunks`, entries ``[c * E, min((c +
    1) * E, n))`` with ``n`` the slot's live count, and nothing for a
    chunk at or past it."""
    tbl = np.asarray(block_tables)
    B, max_blocks = tbl.shape
    s, e = gqa_chunks(B, kv_heads, max_blocks, block_size)
    walk = []
    for b in range(B):
        n = live_block_count(int(np.asarray(lengths)[b]), block_size,
                             max_blocks)
        walk.append([tbl[b, c * e: min((c + 1) * e, n)] if c * e < n
                     else tbl[b, :0] for c in range(s)])
    return walk


# The arrival counters of the last-arriving merge, one int32 per (slot,
# head group), per device, stream and shape: zeroed once, and every call
# that runs to its end leaves them at zero. Calls on one stream run in
# order, so they never share a counter at once, whichever host thread
# launched them (engine threads of two servers share the default
# stream); the first fill of a key is made under a lock.
_GQA_COUNTS: dict = {}
_GQA_COUNTS_LOCK = threading.Lock()


def _gqa_counts(device: torch.device, stream: int, batch: int,
                groups: int) -> torch.Tensor:
    shape = (batch, groups)
    if torch.cuda.is_current_stream_capturing():
        # A captured graph owns its counters, zeroed by a memset captured
        # before the launch: a replay on any stream shares them with no
        # eager call and no other graph.
        return torch.zeros(shape, dtype=torch.int32, device=device)
    key = (device, stream, shape)
    counts = _GQA_COUNTS.get(key)
    if counts is None:
        with _GQA_COUNTS_LOCK:
            counts = _GQA_COUNTS.get(key)
            if counts is None:
                counts = torch.zeros(shape, dtype=torch.int32, device=device)
                _GQA_COUNTS[key] = counts
    return counts


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
    CPU tensors run the plain version; anything else raises.

    The kernel's last-arriving merge counts arrivals in int32 counters
    that each call leaves at zero: one set per device, stream and shape
    for eager calls, and one per captured call, zeroed in the graph. Two
    calls must not use one set at once, so calls on one stream run in
    order, and a graph is not replayed while a replay of it runs."""
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
    if g > GQA_MAX_GROUP or D > GQA_MAX_HEAD_DIM or B > 65535:
        raise ValueError(
            f"paged_gqa_decode_attn: {g} query heads per KV head (max "
            f"{GQA_MAX_GROUP}), head dim {D} (max {GQA_MAX_HEAD_DIM}) or "
            f"{B} slots (max 65535) past the kernel's limits")
    scale = scale if scale is not None else D ** -0.5
    chunks, entries = gqa_chunks(B, KV, max_blocks, bs)
    out = torch.empty_like(q)
    scratch = torch.empty(gqa_scratch_shape(B, KV, g, D, max_blocks, bs),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counts = _gqa_counts(q.device, stream, B, gqa_head_groups(KV)[0])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("paged_decode_attn", "paged_gqa_decode_attn",
                         [p] * 8 + [i] * 8 + [ctypes.c_float, i, p])
    err = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), counts.data_ptr(), B, KV, g, D, bs, max_blocks,
        entries, chunks, float(scale), _build.DTYPE_IDS[q.dtype], stream)
    paged_gqa_decode_attn.launches += 1
    if err != 0:
        raise RuntimeError(
            f"paged_gqa_decode_attn launch failed: cudaError {err}")
    return out


paged_gqa_decode_attn.launches = 0


# ------------------------------------------------------------------- MLA
# Widths the MLA kernel takes: its O accumulators (up to 8 n-tiles of 8
# latent columns per warp) and its shared-memory rows.
MLA_MAX_LATENT = 512
MLA_MAX_ROPE = 128
# The kernel's heads per thread block; the CTAs its grid aims at when
# every chunk is live (twice an H100's 132 SMs: the chunks stay short --
# 4 blocks at the DeepSeek decode shape, the fastest there of 2, 4 and
# 8 by tools/mla_probe.py -- and a dead chunk's CTA exits at once); the
# rows a chunk holds at least, so that its f32 scratch (heads x latent)
# stays small beside the pool rows it reads.
MLA_HEADS_PER_CTA = 32
MLA_CTA_AIM = 2 * 132
MLA_MIN_CHUNK_ROWS = 64
# A chunk's table entries sit in the kernel's shared memory.
MLA_MAX_CHUNK_ENTRIES = 256


def mla_chunks(batch: int, heads: int, max_blocks: int,
               block_size: int) -> tuple[int, int]:
    """(S, E): the MLA kernel cuts each slot's table into S chunks of E
    entries, S * E >= max_blocks. A function of the shapes only -- never
    of the lengths -- so the launch needs no host read and can be
    captured in a CUDA graph."""
    if max_blocks <= 0:
        return 1, 1
    groups = -(-heads // MLA_HEADS_PER_CTA)
    s = max(1, -(-MLA_CTA_AIM // (batch * groups)))
    e = max(-(-max_blocks // s), -(-MLA_MIN_CHUNK_ROWS // block_size))
    e = min(e, max_blocks, MLA_MAX_CHUNK_ENTRIES)
    return -(-max_blocks // e), e


def mla_grid(batch: int, heads: int, max_blocks: int,
             block_size: int) -> dict:
    """The MLA kernel's launch: chunks per slot, table entries per chunk,
    head groups, and CTAs (chunks x head groups x slots)."""
    s, e = mla_chunks(batch, heads, max_blocks, block_size)
    groups = -(-heads // MLA_HEADS_PER_CTA)
    return dict(chunks=s, entries=e, head_groups=groups,
                ctas=s * groups * batch)


def mla_scratch_shape(batch: int, heads: int, latent: int, max_blocks: int,
                      block_size: int) -> tuple:
    """The f32 scratch the MLA kernel writes a chunk's (O, m, l) to:
    (slots, chunks, heads, latent + 2 rounded up to 4, so rows start on
    16 bytes). A function of the shapes only."""
    s, _ = mla_chunks(batch, heads, max_blocks, block_size)
    return (batch, s, heads, -(-(latent + 2) // 4) * 4)


def mla_chunk_walk(block_tables: np.ndarray, lengths: np.ndarray,
                   block_size: int, heads: int) -> List[List[np.ndarray]]:
    """Host-side mirror of the table entries the MLA kernel reads: for
    slot b and chunk c of :func:`mla_chunks`, entries ``[c * E, min((c +
    1) * E, n))`` with ``n`` the slot's live count, and nothing for a
    chunk at or past it."""
    tbl = np.asarray(block_tables)
    B, max_blocks = tbl.shape
    s, e = mla_chunks(B, heads, max_blocks, block_size)
    walk = []
    for b in range(B):
        n = live_block_count(int(np.asarray(lengths)[b]), block_size,
                             max_blocks)
        walk.append([tbl[b, c * e: min((c + 1) * e, n)] if c * e < n
                     else tbl[b, :0] for c in range(s)])
    return walk


def paged_mla_decode_attn_plain(
    q_lat: torch.Tensor, q_rope: torch.Tensor, ckv_pool: torch.Tensor,
    kr_pool: torch.Tensor, block_tables: torch.Tensor,
    lengths: torch.Tensor, *, scale: float,
) -> torch.Tensor:
    """What the MLA kernel computes, in plain PyTorch, reading only live
    blocks: per slot, gather ``table[b, :ceil(len/bs)]`` (capped at the
    table width) of both latent pools, scores ``(q_lat . ckv + q_rope .
    kr) * scale`` in f32, positions at or past the length masked, p
    rounded to the pool dtype before the context product (the
    normaliser sums the unrounded p, floored at 1e-30); zeros for a
    dead slot."""
    B, h, r = q_lat.shape
    bs = ckv_pool.shape[1]
    rope = kr_pool.shape[-1]
    out = torch.zeros_like(q_lat)
    lens = lengths.tolist()
    max_blocks = block_tables.shape[1]
    for b in range(B):
        n = int(lens[b])
        nblk = live_block_count(n, bs, max_blocks)
        if nblk == 0:
            continue
        ids = block_tables[b, :nblk].to(torch.long)
        ckv = ckv_pool[ids].reshape(nblk * bs, r)
        kr = kr_pool[ids].reshape(nblk * bs, rope)
        s = (q_lat[b].float() @ ckv.float().T
             + q_rope[b].float() @ kr.float().T) * scale  # (h, L)
        pos = torch.arange(nblk * bs, device=q_lat.device)
        s = torch.where(pos < n, s, torch.full_like(s, -1e30))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        ctx = p.to(ckv.dtype).float() @ ckv.float()
        out[b] = (ctx / denom).to(q_lat.dtype)
    return out


def paged_mla_decode_attn(
    q_lat: torch.Tensor,  # (B, h, r) wuk-absorbed queries, pool dtype
    q_rope: torch.Tensor,  # (B, h, rope)
    ckv_pool: torch.Tensor,  # (nb, bs, r) compressed-latent pool
    kr_pool: torch.Tensor,  # (nb, bs, rope) shared rope-key pool
    block_tables: torch.Tensor,  # int32 (B, max_blocks), 0 = null block
    lengths: torch.Tensor,  # int32 (B,) live rows incl. this tick's write
    *,
    scale: float,
) -> torch.Tensor:
    """(B, h, r) latent-space context over each slot's live pool blocks
    (the caller decompresses with ``wuv``); zeros for a slot with
    ``lengths[b] == 0``. CUDA tensors launch the kernel, CPU tensors run
    the plain version; anything else raises."""
    if q_lat.device.type == "cpu":
        return paged_mla_decode_attn_plain(
            q_lat, q_rope, ckv_pool, kr_pool, block_tables, lengths,
            scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(
            f"paged_mla_decode_attn: unsupported device {q_lat.device}")
    B, h, r = q_lat.shape
    rope = q_rope.shape[-1]
    nb, bs = ckv_pool.shape[0], ckv_pool.shape[1]
    max_blocks = block_tables.shape[1]
    dtype_id = _build.check_operands(
        "paged_mla_decode_attn", q_lat=q_lat, q_rope=q_rope,
        ckv_pool=ckv_pool, kr_pool=kr_pool)
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q_lat.device:
            raise ValueError(f"{name} on {t.device}, q_lat on {q_lat.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32")
    if tuple(q_rope.shape) != (B, h, rope) \
            or tuple(ckv_pool.shape) != (nb, bs, r) \
            or tuple(kr_pool.shape) != (nb, bs, rope) \
            or tuple(block_tables.shape) != (B, max_blocks) \
            or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"shape mismatch: q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, pools {tuple(ckv_pool.shape)}/"
            f"{tuple(kr_pool.shape)}, tables {tuple(block_tables.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if r > MLA_MAX_LATENT or rope > MLA_MAX_ROPE or B > 65535:
        raise ValueError(
            f"paged_mla_decode_attn: latent width {r} (max "
            f"{MLA_MAX_LATENT}), rope width {rope} (max {MLA_MAX_ROPE}) "
            f"or {B} slots (max 65535) past the kernel's limits")
    chunks, entries = mla_chunks(B, h, max_blocks, bs)
    out = torch.empty_like(q_lat)
    scratch = torch.empty(mla_scratch_shape(B, h, r, max_blocks, bs),
                          dtype=torch.float32, device=q_lat.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("paged_mla_decode_attn", "paged_mla_decode_attn",
                         [p] * 8 + [i] * 8 + [ctypes.c_float, i, p])
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    err = fn(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
        kr_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, h, r, rope, bs, max_blocks,
        entries, chunks, float(scale), dtype_id, stream)
    paged_mla_decode_attn.launches += 1
    if err != 0:
        raise RuntimeError(
            f"paged_mla_decode_attn launch failed: cudaError {err}")
    return out


paged_mla_decode_attn.launches = 0
