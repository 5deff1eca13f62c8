"""Top-level language model, dense and moe families: init / forward /
serving ops.

Port of the dense- and moe-family parts of ``repro/models/model.py``.

Param tree: ``{"embed": (V, d), "final_norm": {"scale": (d,) f32},
"stack": [layer dicts]}`` (plus ``"head"`` when embeddings are untied,
and for the moe family ``"dense_stack"``, the first_k_dense dense
layers before the moe ``"stack"``) -- the reference's tree with the
layer-stacked leaves unstacked into a list, one dict per layer. Caches
are dicts keyed like the stacks. Batch convention: ``tokens`` int (B, S);
``active`` f32 (B,) live-slot mask; ``block_tables`` int32
(B, max_blocks); ``advance`` int32 (B,) bucketed-prefill true lengths.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import (
    gqa_init_cache, gqa_init_paged_cache, mla_init_cache,
    mla_init_paged_cache,
)
from repro_torch.models.layers import rmsnorm, rmsnorm_init

# Values of the f32 head product computed per slice of vocab columns:
# bounds the f32 copy of a bf16 head (the whole of DeepSeek-V3's would be
# 3.7 GB) to 128 MB.
HEAD_SLICE_VALUES = 1 << 25


def _stacks(cfg: ArchConfig) -> List[Tuple[str, str, int]]:
    """(param/cache key, block kind, layers) of the model's stacks, in
    forward order."""
    if cfg.family == "moe":
        dense = ([("dense_stack", "dense", cfg.first_k_dense)]
                 if cfg.first_k_dense else [])
        return dense + [("stack", "moe", cfg.num_layers - cfg.first_k_dense)]
    return [("stack", "dense", cfg.num_layers)]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.frontend:
        raise NotImplementedError(
            f"family {cfg.family!r} (frontend={cfg.frontend!r}) is not "
            "ported yet; the port serves the dense and moe families")


# -------------------------------------------------------------------- init
def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random weights with the reference's tree, shapes, dtypes
    and scales (numpy normals, so not the reference's numbers)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = nn.torch_dtype(cfg.dtype)
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "embed": nn.embed_init(rng, cfg.vocab_size, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = nn.dense_init(rng, cfg.d_model, cfg.vocab_size,
                                       dtype, dev)
    for key, kind, n in _stacks(cfg):
        params[key] = tfm.stack_init(rng, cfg, n, kind, dtype, dev)
    return params


def params_device(params) -> torch.device:
    return params["embed"].device


# ----------------------------------------------------------------- forward
def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits ``x @ head`` with the head upcast to f32, as in the
    reference, one slice of vocab columns at a time so the f32 copy of a
    low-precision head never exists whole."""
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    xf = x.float()
    if head.dtype == torch.float32:
        return xf @ head
    d, V = head.shape
    step = max(1, HEAD_SLICE_VALUES // d)
    out = torch.empty(x.shape[:-1] + (V,), dtype=torch.float32,
                      device=x.device)
    for c in range(0, V, step):
        out[..., c:c + step] = xf @ head[:, c:c + step].float()
    return out


def _cache_length(caches) -> torch.Tensor:
    return caches["stack"].length[0]  # stacked over layers -> layer 0: (B,)


def _backbone(params, cfg: ArchConfig, x, positions, caches, active=None,
              block_tables=None, advance=None, attn_kernel="gather"):
    """The layer stacks; returns (x, new_caches dict or None, aux)."""
    kw = dict(active=active, block_tables=block_tables, advance=advance,
              attn_kernel=attn_kernel)
    aux = tfm.aux_zero(x.device)
    new_caches = {}
    for key, kind, _ in _stacks(cfg):
        x, nc, a = tfm.stack_fwd(params[key], x, positions, cfg, kind,
                                 None if caches is None else caches[key],
                                 **kw)
        aux = {k: aux[k] + a[k] for k in aux}
        new_caches[key] = nc
    return x, (None if caches is None else new_caches), aux


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            caches: Optional[Dict[str, Any]] = None, *,
            last_only: bool = False, attn_kernel: str = "gather"
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], dict]:
    """Full-sequence forward. Returns (logits, new_caches, aux) with aux
    {'loss', 'skip': f32[2] [skipped, total] tile-dots summed over
    layers}. ``last_only`` computes logits at the last (real) position
    only; with ``batch['advance']`` that is row advance-1."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]  # (B, S, d)
    active = batch.get("active")
    if active is not None:
        x = x * active.to(x.dtype)[:, None, None]
    B, S = x.shape[0], x.shape[1]
    if caches is not None:
        offset = torch.broadcast_to(_cache_length(caches), (B,))
    else:
        offset = torch.zeros((B,), dtype=torch.int32, device=x.device)
    positions = offset[:, None] + torch.arange(S, device=x.device,
                                               dtype=torch.int32)[None, :]
    advance = batch.get("advance")
    if advance is not None and cfg.family not in bucketable_families():
        # Masked-tail prefill is exact only for position-causal stacks;
        # MoE capacity routing is batch-shape dependent.
        raise ValueError(
            f"batch['advance'] (bucketed prefill) is not supported for "
            f"family {cfg.family!r}; prefill at exact length instead")
    x, new_caches, aux = _backbone(
        params, cfg, x, positions, caches, active=active,
        block_tables=batch.get("block_tables"), advance=advance,
        attn_kernel=attn_kernel)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        if advance is not None:
            li = torch.clamp(advance.to(device=x.device).long() - 1, 0, S - 1)
            x = torch.gather(
                x, 1, li[:, None, None].expand(B, 1, x.shape[-1]))
        else:
            x = x[:, -1:]
    logits = _logits(params, cfg, x)
    return logits, new_caches, aux


def serving_decode_step(params, cfg: ArchConfig, last_tokens, caches,
                        active, block_tables=None, attn_kernel="gather"):
    """Continuous-batching decode tick. last_tokens: (B, 1); active: f32
    (B,); block_tables: int32 (B, max_blocks) when the caches are paged.
    Returns (logits, new_caches, skip_stats f32[2])."""
    batch = {"tokens": last_tokens, "active": active}
    if block_tables is not None:
        batch["block_tables"] = block_tables
    logits, new_caches, aux = forward(params, cfg, batch, caches,
                                      attn_kernel=attn_kernel)
    return logits, new_caches, aux["skip"]


# ---------------------------------------------------------------- caches
def paged_families() -> Tuple[str, ...]:
    """Families whose serving caches can be paged (the port's subset)."""
    return ("dense", "moe")


def bucketable_families() -> Tuple[str, ...]:
    """Families for which padded-to-bucket prefill is exact (the port's
    subset of the reference's)."""
    return ("dense",)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cuda") -> Dict[str, Any]:
    """Layer-stacked contiguous caches (prefill scratch): GQA k/v, or
    MLA latents and rope keys."""
    _check_family(cfg)
    init = mla_init_cache if cfg.mla is not None else gqa_init_cache
    dtype, dev = nn.torch_dtype(cfg.dtype), resolve_device(device)
    return {key: init(cfg, batch, max_len, dtype, dev, layers=n)
            for key, _, n in _stacks(cfg)}


def init_paged_caches(cfg: ArchConfig, batch: int, num_blocks: int,
                      block_size: int, device="cuda") -> Dict[str, Any]:
    """Pool-backed serving caches: ``num_blocks`` INCLUDES the reserved
    null block 0 (allocatable ids are 1..num_blocks-1). Every layer owns
    its pool; the block tables are shared across layers and stacks."""
    if cfg.family not in paged_families():
        raise ValueError(f"family {cfg.family!r} has no paged KV layout")
    init = (mla_init_paged_cache if cfg.mla is not None
            else gqa_init_paged_cache)
    dtype, dev = nn.torch_dtype(cfg.dtype), resolve_device(device)
    return {key: init(cfg, batch, num_blocks, block_size, dtype, dev,
                      layers=n)
            for key, _, n in _stacks(cfg)}


def insert_slot_paged(big, small, slot: int, block_ids: torch.Tensor,
                      true_len: int):
    """Admission: scatter a freshly prefilled batch=1 contiguous cache's
    rows into the pool blocks ``block_ids`` (int (max_blocks,)) and pin
    slot ``slot``'s length to ``true_len``. Updates ``big`` IN PLACE
    (the reference donates the pool for the same effect) and returns it.
    Rows beyond the allocated blocks (bucket padding) map to table
    entries of 0 and land in the null block."""
    for key in big:
        bp, sp = big[key], small[key]
        nb, bs = bp.k.shape[1], bp.k.shape[2]
        S = sp.k.shape[2]
        p = torch.arange(S, device=bp.k.device)
        dest = block_ids.to(bp.k.device).long()[p // bs] * bs + p % bs
        for pool, rows in ((bp.k, sp.k), (bp.v, sp.v)):
            flat = pool.view((pool.shape[0], nb * bs) + tuple(pool.shape[3:]))
            flat[:, dest] = rows[:, 0].to(flat.dtype)
        bp.length[:, slot] = int(true_len)
    return big
