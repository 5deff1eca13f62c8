"""Top-level language model, dense family: init / forward / serving ops.

Port of the dense-family parts of ``repro/models/model.py``.

Param tree: ``{"embed": (V, d), "final_norm": {"scale": (d,) f32},
"stack": [layer dicts]}`` (plus ``"head"`` when embeddings are untied)
-- the reference's tree with the layer-stacked leaves unstacked into a
list, one dict per layer. Batch convention: ``tokens`` int (B, S);
``active`` f32 (B,) live-slot mask; ``block_tables`` int32
(B, max_blocks); ``advance`` int32 (B,) bucketed-prefill true lengths.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import (
    gqa_init_cache, gqa_init_paged_cache,
)
from repro_torch.models.layers import rmsnorm, rmsnorm_init


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.mla is not None or cfg.frontend:
        raise NotImplementedError(
            f"family {cfg.family!r} (mla={cfg.mla is not None}, "
            f"frontend={cfg.frontend!r}) is not ported yet; the port "
            "serves the dense GQA family")


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
    params["stack"] = tfm.stack_init(rng, cfg, cfg.num_layers, dtype, dev)
    return params


def params_device(params) -> torch.device:
    return params["embed"].device


# ----------------------------------------------------------------- forward
def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x.float() @ head.float()


def _cache_length(caches) -> torch.Tensor:
    return caches["stack"].length[0]  # stacked over layers -> layer 0: (B,)


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
    x, new_stack, aux = tfm.stack_fwd(
        params["stack"], x, positions, cfg,
        None if caches is None else caches["stack"], active=active,
        block_tables=batch.get("block_tables"), advance=advance,
        attn_kernel=attn_kernel,
    )
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        if advance is not None:
            li = torch.clamp(advance.to(device=x.device).long() - 1, 0, S - 1)
            x = torch.gather(
                x, 1, li[:, None, None].expand(B, 1, x.shape[-1]))
        else:
            x = x[:, -1:]
    logits = _logits(params, cfg, x)
    new_caches = None if new_stack is None else {"stack": new_stack}
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
    return ("dense",)


def bucketable_families() -> Tuple[str, ...]:
    """Families for which padded-to-bucket prefill is exact (the port's
    subset of the reference's)."""
    return ("dense",)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cuda") -> Dict[str, Any]:
    """Layer-stacked contiguous caches (prefill scratch)."""
    _check_family(cfg)
    return {"stack": gqa_init_cache(
        cfg, batch, max_len, nn.torch_dtype(cfg.dtype),
        resolve_device(device), layers=cfg.num_layers)}


def init_paged_caches(cfg: ArchConfig, batch: int, num_blocks: int,
                      block_size: int, device="cuda") -> Dict[str, Any]:
    """Pool-backed serving caches: ``num_blocks`` INCLUDES the reserved
    null block 0 (allocatable ids are 1..num_blocks-1)."""
    if cfg.family not in paged_families():
        raise ValueError(f"family {cfg.family!r} has no paged KV layout")
    return {"stack": gqa_init_paged_cache(
        cfg, batch, num_blocks, block_size, nn.torch_dtype(cfg.dtype),
        resolve_device(device), layers=cfg.num_layers)}


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
