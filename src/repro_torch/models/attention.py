"""Attention: GQA and DeepSeek MLA, with contiguous and paged KV caches.

Port of ``repro/models/attention.py``. Prefill runs the chunked
online-softmax attention (plain PyTorch, as it is plain jnp in the
reference); decode writes one row per slot into its cache and attends
over the slot's live prefix, either over the gathered full pool view
(``attn_kernel="gather"``, the parity oracle) or straight out of the
pool with a paged decode kernel (``attn_kernel="paged"``). MLA decode
uses the absorbed-matmul trick: attention runs in the compressed latent
space, so its cache rows stay (kv_lora + rope) wide.

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
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import modules as nn
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_init

_NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, L, KV, hd) [GQA] or ckv (B, L, kv_lora) [MLA]
    v: torch.Tensor  # (B, L, KV, hd) [GQA] or k_rope (B, L, rope) [MLA]
    length: torch.Tensor  # int32 (B,): tokens already in cache, per slot


class PagedKVCache(NamedTuple):
    """Shared pool of fixed-size KV blocks. Block 0 is the NULL block:
    freed slots' table entries point at it, so their masked decode
    writes land harmlessly. The block table is not part of the cache;
    the server owns it and passes it into each decode step."""

    k: torch.Tensor  # (num_blocks, block_size, KV, hd) or (nb, bs, kv_lora)
    v: torch.Tensor  # (num_blocks, block_size, KV, hd) or (nb, bs, rope)
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


# ===================================================================== MLA
def mla_init(rng, cfg: ArchConfig, dtype, device):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    return {
        "wdq": nn.dense_init(rng, d, m.q_lora_rank, dtype, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, device),
        "wuq": nn.dense_init(rng, m.q_lora_rank,
                             h * (m.qk_nope_dim + m.qk_rope_dim), dtype,
                             device),
        "wdkv": nn.dense_init(rng, d, m.kv_lora_rank, dtype, device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, device),
        "wkr": nn.dense_init(rng, d, m.qk_rope_dim, dtype, device),
        "wuk": nn.dense_init(rng, m.kv_lora_rank, h * m.qk_nope_dim, dtype,
                             device),
        "wuv": nn.dense_init(rng, m.kv_lora_rank, h * m.v_head_dim, dtype,
                             device),
        "wo": nn.dense_init(rng, h * m.v_head_dim, d, dtype, device),
    }


def mla_forward(
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
    continuation: bool = False,
    chunk_q: Optional[int] = None,
    chunk_k: Optional[int] = None,
):
    """x: (B, S, d). Prefill (or no cache) decompresses the latents
    through ``wuk``/``wuv`` and runs the chunked attention with KV = H;
    a decode step (cache and S == 1) runs the absorbed decode in the
    latent space, over the gathered pool view (``attn_kernel="gather"``)
    or out of the pool with the paged MLA kernel (``"paged"``). The
    cache's ``k`` holds the latents ckv, its ``v`` the shared rope keys.
    """
    m = cfg.mla
    if continuation:
        # Suffix prefill needs bucketed (masked-tail) prefill to be
        # exact, which excludes every MLA family (moe capacity routing is
        # batch-shape dependent).
        raise NotImplementedError(
            "continuation prefill is not supported for MLA attention")
    B, S, _ = x.shape
    dq_, dk_ = _default_chunks(S)
    chunk_q = chunk_q or dq_
    chunk_k = chunk_k or dk_
    h = cfg.num_heads
    nope, rope_d, vd = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    scale = (nope + rope_d) ** -0.5

    cq = rmsnorm(params["q_norm"], x @ params["wdq"], cfg.norm_eps)
    q = (cq @ params["wuq"]).reshape(B, S, h, nope + rope_d)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = rmsnorm(params["kv_norm"], x @ params["wdkv"], cfg.norm_eps)
    kr = apply_rope((x @ params["wkr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]  # (B, S, rope), all heads

    if cache is None or S > 1:
        # Train/prefill: decompress and run the chunked attention, KV=H.
        k_nope = (ckv @ params["wuk"]).reshape(B, S, h, nope)
        v = (ckv @ params["wuv"]).reshape(B, S, h, vd)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, h, rope_d)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        # Pad v to the qk head dim for the shared attention, slice after.
        v_pad = F.pad(v, (0, nope + rope_d - vd))
        out = _flash_chunked(qq, k, v_pad, q_offset=0,
                             chunk_q=min(chunk_q, S),
                             chunk_k=min(chunk_k, S))[..., :vd]
        new_cache = None
        if cache is not None:
            if isinstance(cache, PagedKVCache):
                raise NotImplementedError(
                    "prefill targets a small contiguous cache; admission "
                    "scatters it into the pool (model.insert_slot_paged)")
            idx = _slot_lengths(cache, B)
            cc = _scatter_rows(cache.k, ckv, idx)
            cr = _scatter_rows(cache.v, kr, idx)
            new_cache = KVCache(cc, cr, _advance_by(idx, S, advance))
    else:
        # Absorbed decode: q_lat[b,h,r] = sum_n q_nope[b,h,n] wuk[r,h,n].
        # The reference keeps q_lat in f32 and casts it to the cache
        # dtype before every use; a product in the model dtype rounds
        # the f32 sum once, to the same dtype.
        wuk = params["wuk"].reshape(m.kv_lora_rank, h, nope)
        cc = cr = None
        if isinstance(cache, PagedKVCache):
            if block_tables is None:
                raise ValueError("paged decode needs block_tables")
            new_cache, idx = _paged_append(cache, block_tables, ckv[:, 0],
                                           kr[:, 0])
            if attn_kernel != "paged":
                cc, cr = _paged_view(new_cache, block_tables)
        else:
            idx = _slot_lengths(cache, B)
            cc = _scatter_rows(cache.k, ckv, idx)
            cr = _scatter_rows(cache.v, kr, idx)
            new_cache = KVCache(cc, cr, idx + 1)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], wuk).to(
            new_cache.k.dtype)
        if cc is None:
            # Straight out of the latent pool: only live table blocks of
            # live slots are read; scores and context stay in the
            # (kv_lora + rope)-wide latent space.
            ctx_lat = kops.paged_mla_decode_attn(
                q_lat, q_rope[:, 0], new_cache.k, new_cache.v,
                block_tables, _paged_eff_lengths(idx, active), scale=scale)
        else:
            L = cc.shape[1]
            s = (torch.einsum("bhr,blr->bhl", q_lat.float(), cc.float())
                 + torch.einsum("bhr,blr->bhl", q_rope[:, 0].float(),
                                cr.float())) * scale
            valid = (torch.arange(L, device=x.device)[None, :]
                     <= idx[:, None])  # (B, L)
            s = torch.where(valid[:, None, :], s,
                            torch.full_like(s, _NEG_INF))
            p = torch.softmax(s, dim=-1)
            ctx_lat = torch.einsum("bhl,blr->bhr", p.to(cc.dtype).float(),
                                   cc.float())
        wuv = params["wuv"].reshape(m.kv_lora_rank, h, vd)
        out = torch.einsum("bhr,rhv->bhv", ctx_lat.to(wuv.dtype), wuv)
        out = out[:, None].to(x.dtype)  # (B, 1, h, vd)

    y = out.reshape(B, S, h * vd).to(x.dtype) @ params["wo"]
    return y, new_cache


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device, layers: int = 1) -> KVCache:
    """Layer-stacked contiguous latent cache: ckv (layers, batch,
    max_len, kv_lora) and rope keys (layers, batch, max_len, rope)."""
    m = cfg.mla
    return KVCache(
        k=torch.zeros((layers, batch, max_len, m.kv_lora_rank), dtype=dtype,
                      device=device),
        v=torch.zeros((layers, batch, max_len, m.qk_rope_dim), dtype=dtype,
                      device=device),
        length=torch.zeros((layers, batch), dtype=torch.int32, device=device),
    )


def mla_init_paged_cache(cfg: ArchConfig, batch: int, num_blocks: int,
                         block_size: int, dtype, device,
                         layers: int = 1) -> PagedKVCache:
    """Layer-stacked latent pools: (layers, num_blocks, block_size,
    kv_lora) and (layers, num_blocks, block_size, rope)."""
    m = cfg.mla
    return PagedKVCache(
        k=torch.zeros((layers, num_blocks, block_size, m.kv_lora_rank),
                      dtype=dtype, device=device),
        v=torch.zeros((layers, num_blocks, block_size, m.qk_rope_dim),
                      dtype=dtype, device=device),
        length=torch.zeros((layers, batch), dtype=torch.int32, device=device),
    )
