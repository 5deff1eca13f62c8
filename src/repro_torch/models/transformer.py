"""Block and stack assembly for the dense, moe, ssm and hybrid families.

Port of ``repro/models/transformer.py``:

  dense  : [attn + mlp] * L
  moe    : [attn + dense-mlp] * first_k_dense, then [attn + moe] * rest
  ssm    : [mamba2] * L
  hybrid : [[mamba2] * attn_every + shared attn block] * (L // attn_every)
           + [mamba2] * (L % attn_every)

where attn is MLA when the config has one, else GQA, and the hybrid's
one attention+MLP block has ONE set of weights shared by all its
applications, each with its own KV cache. The reference scans over
layer-stacked parameters; here the layers are a Python list and the
stack is a Python loop. Layer-stacked caches stay stacked: each layer
works on views of them (``cache.k[l]`` / ``cache.v[l]``, which its
attention updates in place; an ssm layer's new conv window and state
are copied into ``conv[l]`` / ``h[l]``), and the stack returns the same
buffers with the new per-layer lengths.

Sequence parallelism (``cfg.seq_shard`` inside a sharded training step
or prefill whose plan has a model axis, sequences longer than one
token): between blocks the residual stream is this rank's slice of the
sequence over 'model', as the reference's ``constrain(h, P(("pod",
"data"), "model", None))`` lays it out; ``model.forward`` cuts it
before the first block and gathers it after the last. A block runs its
norms and residual adds on the slice. Its tensor-parallel regions
(GQA/MLA heads, the Mamba2 mixer's heads, the MLP's ``d_ff`` cut, the
expert-parallel MoE) open with an all-gather of the sequence and close
with a reduce-scatter (``collectives.sp_open`` / ``sp_close``); a
region every model rank computes alike (gathered attention, a
gathered mixer, MLP or MoE) opens with
``seq_gather`` and closes with ``seq_split``. Each rank's
gradient of a norm's scale then covers its own tokens only, so it is
summed over 'model' once. No value changes.

Activation checkpointing (``cfg.remat``, training only: no caches, grad
enabled): ``"full"`` recomputes each block's forward in the backward,
``"dots"`` keeps only its 2-D matmul outputs (the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest. Neither
changes a value.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch.utils import checkpoint as torch_ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (
    KVCache, attn_init, gqa_forward, gqa_init_cache, mla_forward, mla_init,
)
from repro_torch.models.layers import (
    mlp_fwd, mlp_init, rmsnorm, rmsnorm_init,
)
from repro_torch.parallel import sharding as shd


def aux_zero(device) -> dict:
    """The per-block aux record: router load-balance loss and the SparCE
    ``[skipped, total]`` tile-dot accounting of the dense MLPs."""
    return {
        "loss": torch.zeros((), dtype=torch.float32, device=device),
        "skip": torch.zeros((2,), dtype=torch.float32, device=device),
    }


# The matmuls the "dots" policy keeps (2-D: no batch dims).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (torch_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ArchConfig, caches):
    """``fn`` under ``cfg.remat`` when training (no caches, grad on)."""
    if cfg.remat == "none" or caches is not None or (
            not torch.is_grad_enabled()):
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            torch_ckpt.create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"remat must be none|full|dots, got {cfg.remat!r}")
    return functools.partial(torch_ckpt.checkpoint, fn, use_reentrant=False,
                             **kw)


def block_init(rng, cfg: ArchConfig, kind: str, dtype, device):
    d = cfg.d_model
    if kind == "ssm":
        return {"norm": rmsnorm_init(d, dtype, device),
                "mixer": ssm_lib.mamba2_init(rng, cfg, dtype, device)}
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


def _shard_scale(scale: torch.Tensor) -> torch.Tensor:
    """A norm's scale applied to this rank's sequence shard: its
    gradient is summed over 'model' once (each rank's covers its own
    tokens)."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    return collectives.tp_open(scale, shd.SEQ_AXIS)


def _region_open(x: torch.Tensor) -> torch.Tensor:
    """The sequence shard gathered for a region every model rank
    computes alike."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    return collectives.seq_gather(x, shd.SEQ_AXIS, 1)


def _region_close(y: torch.Tensor) -> torch.Tensor:
    """This rank's sequence shard of such a region's output."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    return collectives.seq_split(y, shd.SEQ_AXIS, 1)


def _norm(params, x, cfg: ArchConfig, sp: bool) -> torch.Tensor:
    if sp:
        params = {"scale": _shard_scale(params["scale"])}
    return rmsnorm(params, x, cfg.norm_eps)


def block_fwd(params, x, positions, cfg: ArchConfig, kind: str, cache=None,
              active: Optional[torch.Tensor] = None, block_tables=None,
              advance=None, attn_kernel: str = "gather",
              continuation: bool = False):
    """Returns (x, new_cache, aux). ``active`` (f32 (B,), serving only)
    gates every residual delta, so a dead slot's residual stream stays
    identically zero through the stack and its MLP gate tiles are
    all-zero (dead) tiles. ``continuation`` marks a prefix-cache suffix
    prefill (see ``attention.gqa_forward``). Inside a sharded training
    step the ambient plan gives the block this rank's view: its
    tensor-parallel slices, or its sharded leaves gathered; under
    sequence parallelism ``x`` is this rank's slice of the sequence."""
    plan = shd.current_plan()
    moe_ep = False
    if plan is not None:
        sp = plan.seq_parallel(cfg, positions.shape[-1])
        moe_ep = kind == "moe" and plan.moe_groups(cfg)[0] == "ep"
        params, cfg, mlp_axis = plan.block(params, cfg, kind)
    else:
        sp, mlp_axis = False, cfg.tp_axis

    def alike(fn, h):
        # A region every model rank computes alike: on the gathered
        # sequence under sequence parallelism.
        if not sp:
            return fn(h)
        out, *rest = fn(_region_open(h))
        return (_region_close(out), *rest)

    def gate(h):
        if active is None:
            return h
        return h * active.to(h.dtype)[:, None, None]

    aux = aux_zero(x.device)
    if kind == "ssm":
        mixer = functools.partial(ssm_lib.mamba2_forward, params["mixer"],
                                  cfg=cfg, cache=cache)
        hn = _norm(params["norm"], x, cfg, sp)
        # A tensor-parallel mixer (tp_axis set) runs this rank's heads
        # and opens and closes itself.
        h, new_cache = (mixer(hn, seq=sp, heads=plan.mixer_heads(cfg))
                        if cfg.tp_axis is not None else alike(mixer, hn))
        return x + gate(h), new_cache, aux
    attn_fn = mla_forward if cfg.mla is not None else gqa_forward
    attn = functools.partial(
        attn_fn, params["attn"], positions=positions, cfg=cfg, cache=cache,
        block_tables=block_tables, advance=advance, attn_kernel=attn_kernel,
        active=active, continuation=continuation)
    hn = _norm(params["attn_norm"], x, cfg, sp)
    # A tensor-parallel attention (tp_axis set) opens and closes itself.
    h, new_cache = (attn(hn, seq=sp) if cfg.tp_axis is not None
                    else alike(attn, hn))
    x = x + gate(h)
    hn = _norm(params["mlp_norm"], x, cfg, sp)
    if kind == "moe":
        moe = functools.partial(moe_lib.moe_forward, params["moe"], cfg=cfg)
        h, moe_aux, _occ = moe(hn, seq=sp) if moe_ep else alike(moe, hn)
        aux["loss"] = aux["loss"] + moe_aux
    else:
        mlp = functools.partial(mlp_fwd, params["mlp"], act=cfg.mlp_act,
                                scfg=cfg.sparsity, tp_axis=mlp_axis,
                                seq=sp)
        h, skip = mlp(hn) if mlp_axis is not None else alike(mlp, hn)
        aux["skip"] = aux["skip"] + skip
    return x + gate(h), new_cache, aux


def stack_init(rng, cfg: ArchConfig, n_layers: int, kind: str, dtype,
               device):
    return [block_init(rng, cfg, kind, dtype, device)
            for _ in range(n_layers)]


def stack_fwd(layers, x, positions, cfg: ArchConfig, kind: str,
              caches=None, active=None, block_tables=None, advance=None,
              attn_kernel: str = "gather", continuation: bool = False):
    """Python loop over the layers. ``caches`` is a layer-stacked
    KVCache/PagedKVCache/SSMCache (leading layer axis on every field)."""
    aux = aux_zero(x.device)
    lengths = []
    ssm = isinstance(caches, ssm_lib.SSMCache)
    block = _remat(block_fwd, cfg, caches)
    for i, lp in enumerate(layers):
        lc: Any = None
        if caches is not None:
            lc = type(caches)(*(f[i] for f in caches))
        x, nc, a = block(
            lp, x, positions, cfg, kind, cache=lc, active=active,
            block_tables=block_tables, advance=advance,
            attn_kernel=attn_kernel, continuation=continuation,
        )
        aux = {k: aux[k] + a[k] for k in aux}
        if ssm:
            lc.conv.copy_(nc.conv)
            lc.h.copy_(nc.h)
        elif caches is not None:
            lengths.append(nc.length)
    if caches is None or ssm:
        return x, caches, aux
    return x, type(caches)(caches.k, caches.v, torch.stack(lengths)), aux


# ------------------------------------------------------- zamba2-style hybrid
def _hybrid_shape(cfg: ArchConfig):
    """(attn_every, super-groups, trailing ssm layers)."""
    every = cfg.attn_every
    n_super = cfg.num_layers // every
    return every, n_super, cfg.num_layers - n_super * every


def hybrid_init(rng, cfg: ArchConfig, dtype, device):
    """``n_super`` groups of ``attn_every`` ssm layers (a list of lists of
    layer dicts, the reference's ``(n_super, every)``-stacked leaves),
    the ONE shared attention+MLP block, and the trailing ssm layers."""
    every, n_super, trailing = _hybrid_shape(cfg)
    p = {
        "groups": [stack_init(rng, cfg, every, "ssm", dtype, device)
                   for _ in range(n_super)],
        "shared_attn": block_init(rng, cfg, "dense", dtype, device),
    }
    if trailing:
        p["trailing"] = stack_init(rng, cfg, trailing, "ssm", dtype, device)
    return p


def hybrid_fwd(params, x, positions, cfg: ArchConfig, caches=None,
               active=None, block_tables=None, advance=None):
    """caches: ``{"ssm": SSMCache (n_super, every, ...), "attn": KVCache
    (n_super, ...), "trailing": SSMCache (trailing, ...)}``. Group ``i``
    runs its ssm layers, then the shared block with the weights every
    group uses and the KV cache of application ``i``. ``advance`` is
    accepted for signature uniformity and must be None: forward refuses
    bucketed prefill for this family."""
    if advance is not None:
        raise AssertionError("hybrid prefill is exact-length only")
    every, n_super, trailing = _hybrid_shape(cfg)
    shared = params["shared_attn"]
    shared_fwd = _remat(block_fwd, cfg, caches)
    aux = aux_zero(x.device)
    lengths = []
    for i, group in enumerate(params["groups"]):
        ssm_c = attn_c = None
        if caches is not None:
            ssm_c = ssm_lib.SSMCache(*(f[i] for f in caches["ssm"]))
            attn_c = KVCache(*(f[i] for f in caches["attn"]))
        x, _, a1 = stack_fwd(group, x, positions, cfg, "ssm", ssm_c,
                             active=active)
        x, nc, a2 = shared_fwd(shared, x, positions, cfg, "dense",
                               cache=attn_c, active=active)
        aux = {k: aux[k] + a1[k] + a2[k] for k in aux}
        if caches is not None:
            lengths.append(nc.length)
    new_caches = None
    if caches is not None:
        attn = caches["attn"]
        new_caches = dict(caches, attn=KVCache(attn.k, attn.v,
                                               torch.stack(lengths)))
    if trailing:
        x, _, a = stack_fwd(params["trailing"], x, positions, cfg, "ssm",
                            None if caches is None else caches["trailing"],
                            active=active)
        aux = {k: aux[k] + a[k] for k in aux}
    return x, new_caches, aux


def hybrid_init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype,
                       device):
    """The reference's hybrid cache tree: per-group ssm states, one KV
    cache per application of the shared block, trailing ssm states."""
    every, n_super, trailing = _hybrid_shape(cfg)
    ssm_c = ssm_lib.mamba2_init_cache(cfg, batch, dtype, device,
                                      layers=n_super * every)
    caches = {
        "ssm": ssm_lib.SSMCache(*(
            f.reshape((n_super, every) + tuple(f.shape[1:]))
            for f in ssm_c)),
        "attn": gqa_init_cache(cfg, batch, max_len, dtype, device,
                               layers=n_super),
    }
    if trailing:
        caches["trailing"] = ssm_lib.mamba2_init_cache(
            cfg, batch, dtype, device, layers=trailing)
    return caches
