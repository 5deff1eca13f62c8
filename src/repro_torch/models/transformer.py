"""Block and stack assembly for the dense family: [attn + mlp] * L.

Port of the dense parts of ``repro/models/transformer.py``. The
reference scans over layer-stacked parameters; here the layers are a
Python list and the stack is a Python loop. Layer-stacked caches stay
stacked: each layer works on views ``cache.k[l]`` / ``cache.v[l]`` that
its attention updates in place, and the stack returns the same buffers
with the new per-layer lengths.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attn_init, gqa_forward
from repro_torch.models.layers import (
    mlp_fwd, mlp_init, rmsnorm, rmsnorm_init,
)


def aux_zero(device) -> dict:
    """The per-block aux record: router loss (always 0 for the dense
    family) and the SparCE ``[skipped, total]`` tile-dot accounting."""
    return {
        "loss": torch.zeros((), dtype=torch.float32, device=device),
        "skip": torch.zeros((2,), dtype=torch.float32, device=device),
    }


def block_init(rng, cfg: ArchConfig, dtype, device):
    d = cfg.d_model
    return {
        "attn_norm": rmsnorm_init(d, dtype, device),
        "mlp_norm": rmsnorm_init(d, dtype, device),
        "attn": attn_init(rng, cfg, dtype, device),
        "mlp": mlp_init(rng, d, cfg.d_ff, cfg.mlp_act, dtype, device),
    }


def block_fwd(params, x, positions, cfg: ArchConfig, cache=None,
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
    h, new_cache = gqa_forward(
        params["attn"], rmsnorm(params["attn_norm"], x, cfg.norm_eps),
        positions, cfg, cache=cache, block_tables=block_tables,
        advance=advance, attn_kernel=attn_kernel, active=active,
    )
    x = x + gate(h)
    hn = rmsnorm(params["mlp_norm"], x, cfg.norm_eps)
    h, skip = mlp_fwd(params["mlp"], hn, cfg.mlp_act, cfg.sparsity)
    aux["skip"] = aux["skip"] + skip
    return x + gate(h), new_cache, aux


def stack_init(rng, cfg: ArchConfig, n_layers: int, dtype, device):
    return [block_init(rng, cfg, dtype, device) for _ in range(n_layers)]


def stack_fwd(layers, x, positions, cfg: ArchConfig, caches=None,
              active=None, block_tables=None, advance=None,
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
            lp, x, positions, cfg, cache=lc, active=active,
            block_tables=block_tables, advance=advance,
            attn_kernel=attn_kernel,
        )
        aux = {k: aux[k] + a[k] for k in aux}
        if caches is not None:
            lengths.append(nc.length)
    if caches is None:
        return x, None, aux
    return x, type(caches)(caches.k, caches.v, torch.stack(lengths)), aux
