"""GQA attention with contiguous and paged KV caches.

Port of the GQA parts of ``repro/models/attention.py``. Prefill runs the
chunked online-softmax attention (plain PyTorch, as it is plain jnp in
the reference); decode writes one row per slot into its cache and
attends over the slot's live prefix, either over the gathered full pool
view (``attn_kernel="gather"``, the parity oracle) or straight out of
the pool with the paged decode kernel (``attn_kernel="paged"``).

In-place updates: the reference's caches are immutable pytrees. Here a
layer's cache tensors are views into the layer-stacked buffers
(``(L, nb, bs, KV, hd)`` pools, ``(L, B, max_len, KV, hd)`` prefill
caches), and :func:`_paged_append` / :func:`_scatter_rows` write the new
rows into them IN PLACE; the returned cache carries the same buffers and
the new lengths.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import modules as nn
from repro_torch.models.layers import apply_rope

_NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, L, KV, hd)
    v: torch.Tensor  # (B, L, KV, hd)
    length: torch.Tensor  # int32 (B,): tokens already in cache, per slot


class PagedKVCache(NamedTuple):
    """Shared pool of fixed-size KV blocks. Block 0 is the NULL block:
    freed slots' table entries point at it, so their masked decode
    writes land harmlessly. The block table is not part of the cache;
    the server owns it and passes it into each decode step."""

    k: torch.Tensor  # (num_blocks, block_size, KV, hd)
    v: torch.Tensor  # (num_blocks, block_size, KV, hd)
    length: torch.Tensor  # int32 (B,)

    @property
    def block_size(self) -> int:
        return self.k.shape[1]


def _slot_lengths(cache, batch: int) -> torch.Tensor:
    """Per-slot lengths (B,), int32."""
    return torch.broadcast_to(cache.length.to(torch.int32), (batch,))


def _paged_append(cache: PagedKVCache, block_tables: torch.Tensor,
                  upd_k: torch.Tensor, upd_v: torch.Tensor
                  ) -> Tuple[PagedKVCache, torch.Tensor]:
    """Write one new row per slot into the pool IN PLACE (no view
    gather). Returns (cache with lengths + 1, pre-write lengths)."""
    nb, bs = cache.k.shape[0], cache.k.shape[1]
    B, max_blocks = block_tables.shape
    idx = _slot_lengths(cache, B)
    # A live slot's current block is always assigned (the server grows
    # tables before the tick); dead slots clamp into their null row.
    slot_blk = torch.clamp_max(idx // bs, max_blocks - 1).long()
    blk = torch.gather(block_tables.long(), 1, slot_blk[:, None])[:, 0]
    row = blk * bs + (idx % bs).long()
    kf = cache.k.view((nb * bs,) + tuple(cache.k.shape[2:]))
    vf = cache.v.view((nb * bs,) + tuple(cache.v.shape[2:]))
    kf[row] = upd_k.to(kf.dtype)
    vf[row] = upd_v.to(vf.dtype)
    return PagedKVCache(cache.k, cache.v, idx + 1), idx


def _paged_view(cache: PagedKVCache, block_tables: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, max_blocks * block_size, ...) per-slot views of the pool --
    the gather path, which materializes EVERY table entry."""
    nb, bs = cache.k.shape[0], cache.k.shape[1]
    B, max_blocks = block_tables.shape
    kf = cache.k.view((nb * bs,) + tuple(cache.k.shape[2:]))
    vf = cache.v.view((nb * bs,) + tuple(cache.v.shape[2:]))
    gather = (block_tables.long()[:, :, None] * bs
              + torch.arange(bs, device=kf.device)[None, None, :])
    flat_idx = gather.reshape(B, max_blocks * bs)
    return kf[flat_idx], vf[flat_idx]


def _paged_eff_lengths(idx: torch.Tensor, active) -> torch.Tensor:
    """Rows the paged kernel attends over per slot, including this
    tick's write: 0 for inactive slots, so nothing of theirs is read."""
    eff = idx + 1
    if active is None:
        return eff
    return torch.where(active.float() > 0, eff, torch.zeros_like(eff))


def _advance_by(idx: torch.Tensor, S: int, advance) -> torch.Tensor:
    """New cache lengths after writing S rows; ``advance`` overrides S
    for bucketed prefill (only the first advance[b] rows are real)."""
    if advance is None:
        return idx + S
    return idx + advance.to(device=idx.device, dtype=torch.int32)


def _scatter_rows(buf: torch.Tensor, upd: torch.Tensor,
                  starts: torch.Tensor) -> torch.Tensor:
    """Write upd[b] into buf[b] at row offset starts[b], IN PLACE.

    buf: (B, L, ...), upd: (B, S, ...), starts: int (B,). Starts clamp
    so the update fits, like the reference's dynamic_update_slice."""
    B, L = buf.shape[0], buf.shape[1]
    S = upd.shape[1]
    st = torch.clamp(starts.long(), 0, L - S)
    rows = st[:, None] + torch.arange(S, device=buf.device)[None, :]
    buf[torch.arange(B, device=buf.device)[:, None], rows] = upd.to(buf.dtype)
    return buf


# =============================================================== GQA / MHA
def attn_init(rng, cfg: ArchConfig, dtype, device):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": nn.dense_init(rng, d, h * hd, dtype, device),
        "wk": nn.dense_init(rng, d, kv * hd, dtype, device),
        "wv": nn.dense_init(rng, d, kv * hd, dtype, device),
        "wo": nn.dense_init(rng, h * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
    return p


def _flash_chunked(q, k, v, *, q_offset: int, chunk_q: int, chunk_k: int,
                   causal: bool = True) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, H, D), k/v: (B, Sk, KV, D),
    H = g * KV. Loops q chunks (outer) and kv chunks (inner) carrying
    (acc, m, l) in f32, like the reference's double scan."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = D ** -0.5
    nq = max(1, Sq // chunk_q)
    while Sq % nq:
        nq -= 1
    nk = max(1, Sk // chunk_k)
    while Sk % nk:
        nk -= 1
    cq, ck = Sq // nq, Sk // nk
    qc = q.reshape(B, nq, cq, KV, g, D)
    kc = k.reshape(B, nk, ck, KV, D)
    vc = v.reshape(B, nk, ck, KV, D)
    dev = q.device
    outs = []
    for iq in range(nq):
        qblk = qc[:, iq].float()  # (B, cq, KV, g, D)
        q_pos = q_offset + iq * cq + torch.arange(cq, device=dev)
        acc = torch.zeros((B, cq, KV, g, D), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, g, cq), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, g, cq), dtype=torch.float32, device=dev)
        for jk in range(nk):
            kblk, vblk = kc[:, jk], vc[:, jk]  # (B, ck, KV, D)
            k_pos = jk * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk.float()) * scale
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bqkgd",
                              p.to(vblk.dtype).float(), vblk.float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        outs.append(acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None])
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _default_chunks(S: int) -> Tuple[int, int]:
    """(chunk_q, chunk_k) for the chunked attention (the reference's)."""
    return min(S, 512), min(S, 1024)


def gqa_forward(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    *,
    cache=None,
    block_tables: Optional[torch.Tensor] = None,
    advance: Optional[torch.Tensor] = None,
    attn_kernel: str = "gather",
    active: Optional[torch.Tensor] = None,
    chunk_q: Optional[int] = None,
    chunk_k: Optional[int] = None,
):
    """x: (B, S, d). With a cache and S == 1 -> decode step.

    ``cache`` is a contiguous :class:`KVCache` (prefill, or contiguous
    decode) or a :class:`PagedKVCache` (decode only; prefill targets a
    small contiguous cache that admission scatters into pool blocks).
    ``advance`` (int32 (B,)) is the bucketed-prefill true length.
    ``attn_kernel`` picks the paged decode path: 'gather' materializes
    the full per-slot pool view, 'paged' runs the paged decode kernel,
    which reads only live blocks of live slots (``active`` marks them).
    """
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q.reshape(B, S, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, kv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, kv, hd)
    dq, dk = _default_chunks(S)
    chunk_q = chunk_q or dq
    chunk_k = chunk_k or dk

    if cache is None:
        out = _flash_chunked(q, k, v, q_offset=0, chunk_q=min(chunk_q, S),
                             chunk_k=min(chunk_k, S))
        new_cache = None
    elif S == 1:
        # Decode: write k/v at each slot's own length, attend over that
        # slot's live prefix.
        g = h // kv
        qd = q.reshape(B, kv, g, hd)
        ck = cv = None
        if isinstance(cache, PagedKVCache):
            if block_tables is None:
                raise ValueError("paged decode needs block_tables")
            new_cache, idx = _paged_append(cache, block_tables,
                                           k[:, 0], v[:, 0])
            if attn_kernel != "paged":
                ck, cv = _paged_view(new_cache, block_tables)
        else:
            idx = _slot_lengths(cache, B)
            ck = _scatter_rows(cache.k, k, idx)
            cv = _scatter_rows(cache.v, v, idx)
            new_cache = KVCache(ck, cv, idx + 1)
        if ck is None:
            o = kops.paged_decode_attn(
                qd, new_cache.k, new_cache.v, block_tables,
                _paged_eff_lengths(idx, active), scale=hd ** -0.5)
        else:
            L = ck.shape[1]
            s = torch.einsum("bkgd,blkd->bkgl", qd.float(),
                             ck.float()) * (hd ** -0.5)
            valid = (torch.arange(L, device=x.device)[None, :]
                     <= idx[:, None])  # (B, L)
            s = torch.where(valid[:, None, None, :], s,
                            torch.full_like(s, _NEG_INF))
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgl,blkd->bkgd", p.to(cv.dtype).float(),
                             cv.float())
        out = o.reshape(B, 1, h, hd).to(x.dtype)
    else:
        if isinstance(cache, PagedKVCache):
            raise NotImplementedError(
                "prefill targets a small contiguous cache; admission "
                "scatters it into the pool (model.insert_slot_paged)")
        idx = _slot_lengths(cache, B)
        ck = _scatter_rows(cache.k, k, idx)
        cv = _scatter_rows(cache.v, v, idx)
        out = _flash_chunked(q, k, v, q_offset=0, chunk_q=min(chunk_q, S),
                             chunk_k=min(chunk_k, S))
        new_cache = KVCache(ck, cv, _advance_by(idx, S, advance))

    y = out.reshape(B, S, h * hd) @ params["wo"]
    return y, new_cache


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device, layers: int = 1) -> KVCache:
    """Layer-stacked contiguous cache: (layers, batch, max_len, KV, hd)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (layers, batch, max_len, kv, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((layers, batch), dtype=torch.int32, device=device),
    )


def gqa_init_paged_cache(cfg: ArchConfig, batch: int, num_blocks: int,
                         block_size: int, dtype, device,
                         layers: int = 1) -> PagedKVCache:
    """Layer-stacked pool: (layers, num_blocks, block_size, KV, hd)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (layers, num_blocks, block_size, kv, hd)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((layers, batch), dtype=torch.int32, device=device),
    )
