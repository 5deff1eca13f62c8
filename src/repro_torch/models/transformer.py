"""Block and stack assembly for the dense and moe families.

Port of the dense and moe parts of ``repro/models/transformer.py``:

  dense : [attn + mlp] * L
  moe   : [attn + dense-mlp] * first_k_dense, then [attn + moe] * rest

where attn is MLA when the config has one, else GQA. The reference
scans over layer-stacked parameters; here the layers are a Python list
and the stack is a Python loop. Layer-stacked caches stay stacked: each
layer works on views ``cache.k[l]`` / ``cache.v[l]`` that its attention
updates in place, and the stack returns the same buffers with the new
per-layer lengths.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (
    attn_init, gqa_forward, mla_forward, mla_init,
)
from repro_torch.models.layers import (
    mlp_fwd, mlp_init, rmsnorm, rmsnorm_init,
)


def aux_zero(device) -> dict:
    """The per-block aux record: router load-balance loss and the SparCE
    ``[skipped, total]`` tile-dot accounting of the dense MLPs."""
    return {
        "loss": torch.zeros((), dtype=torch.float32, device=device),
        "skip": torch.zeros((2,), dtype=torch.float32, device=device),
    }


def block_init(rng, cfg: ArchConfig, kind: str, dtype, device):
    d = cfg.d_model
    p = {
        "attn_norm": rmsnorm_init(d, dtype, device),
        "mlp_norm": rmsnorm_init(d, dtype, device),
        "attn": (mla_init(rng, cfg, dtype, device) if cfg.mla is not None
                 else attn_init(rng, cfg, dtype, device)),
    }
    if kind == "moe":
        p["moe"] = moe_lib.moe_init(rng, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(rng, d, cfg.d_ff, cfg.mlp_act, dtype, device)
    return p


def block_fwd(params, x, positions, cfg: ArchConfig, kind: str, cache=None,
              active: Optional[torch.Tensor] = None, block_tables=None,
              advance=None, attn_kernel: str = "gather"):
    """Returns (x, new_cache, aux). ``active`` (f32 (B,), serving only)
    gates every residual delta, so a dead slot's residual stream stays
    identically zero through the stack and its MLP gate tiles are
    all-zero (dead) tiles."""

    def gate(h):
        if active is None:
            return h
        return h * active.to(h.dtype)[:, None, None]

    aux = aux_zero(x.device)
    attn_fn = mla_forward if cfg.mla is not None else gqa_forward
    h, new_cache = attn_fn(
        params["attn"], rmsnorm(params["attn_norm"], x, cfg.norm_eps),
        positions, cfg, cache=cache, block_tables=block_tables,
        advance=advance, attn_kernel=attn_kernel, active=active,
    )
    x = x + gate(h)
    hn = rmsnorm(params["mlp_norm"], x, cfg.norm_eps)
    if kind == "moe":
        h, moe_aux, _occ = moe_lib.moe_forward(params["moe"], hn, cfg)
        aux["loss"] = aux["loss"] + moe_aux
    else:
        h, skip = mlp_fwd(params["mlp"], hn, cfg.mlp_act, cfg.sparsity)
        aux["skip"] = aux["skip"] + skip
    return x + gate(h), new_cache, aux


def stack_init(rng, cfg: ArchConfig, n_layers: int, kind: str, dtype,
               device):
    return [block_init(rng, cfg, kind, dtype, device)
            for _ in range(n_layers)]


def stack_fwd(layers, x, positions, cfg: ArchConfig, kind: str,
              caches=None, active=None, block_tables=None, advance=None,
              attn_kernel: str = "gather"):
    """Python loop over the layers. ``caches`` is a layer-stacked
    KVCache/PagedKVCache (leading layer axis on every field)."""
    aux = aux_zero(x.device)
    lengths = []
    for i, lp in enumerate(layers):
        lc: Any = None
        if caches is not None:
            lc = type(caches)(caches.k[i], caches.v[i], caches.length[i])
        x, nc, a = block_fwd(
            lp, x, positions, cfg, kind, cache=lc, active=active,
            block_tables=block_tables, advance=advance,
            attn_kernel=attn_kernel,
        )
        aux = {k: aux[k] + a[k] for k in aux}
        if caches is not None:
            lengths.append(nc.length)
    if caches is None:
        return x, None, aux
    return x, type(caches)(caches.k, caches.v, torch.stack(lengths)), aux
