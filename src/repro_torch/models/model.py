"""Top-level language model for every family the reference defines
(dense, moe, ssm, hybrid, vlm, audio): init / forward / loss / serving
ops. Port of ``repro/models/model.py``.

Param tree: ``{"embed": (V, d), "final_norm": {"scale": (d,) f32},
"stack": [layer dicts]}`` (plus ``"head"`` when embeddings are untied;
for the audio frontend (``frontend="codes"``) ``"embed"`` is (K, V, d),
one table per codebook, and ``"heads"`` (K, d, V) replaces ``"head"``;
for the moe family ``"dense_stack"``, the first_k_dense dense layers
before the moe ``"stack"``; for the hybrid family ``"hybrid"`` in place
of ``"stack"``: ``{"groups": [[ssm layer dicts]], "shared_attn": block
dict, "trailing": [ssm layer dicts]}``) -- the reference's tree with the
layer-stacked leaves unstacked into lists, one dict per layer. Caches
are dicts keyed like the stacks; the ssm family's are
:class:`~repro_torch.models.ssm.SSMCache` states, which only the
contiguous layout holds. Batch convention: ``tokens`` int (B, S)
(audio: (B, K, S) codebook streams); ``patch_embeds`` (B, P, d), vlm
only, prepended in prefill and training (decode steps pass tokens
only); ``loss_mask`` f32 (B, S), optional (1 = the position counts in
the loss); ``active`` f32 (B,) live-slot mask; ``block_tables`` int32
(B, max_blocks); ``advance`` int32 (B,) bucketed-prefill true lengths
(counting the patch rows). Targets are ``tokens`` shifted left by one
inside the loss.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import modules as nn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import (
    KVCache, gqa_init_cache, gqa_init_paged_cache, mla_init_cache,
    mla_init_paged_cache,
)
from repro_torch.models.layers import rmsnorm, rmsnorm_init
from repro_torch.parallel import sharding as shd

# Values of the f32 head product computed per slice of vocab columns:
# bounds the f32 copy of a bf16 head (the whole of DeepSeek-V3's would be
# 3.7 GB) to 128 MB.
HEAD_SLICE_VALUES = 1 << 25


def _stacks(cfg: ArchConfig) -> List[Tuple[str, str, int]]:
    """(param/cache key, block kind, layers) of the model's stacks, in
    forward order (the hybrid family has none: see ``tfm.hybrid_fwd``)."""
    if cfg.family == "hybrid":
        return []
    if cfg.family == "ssm":
        return [("stack", "ssm", cfg.num_layers)]
    if cfg.family == "moe":
        dense = ([("dense_stack", "dense", cfg.first_k_dense)]
                 if cfg.first_k_dense else [])
        return dense + [("stack", "moe", cfg.num_layers - cfg.first_k_dense)]
    return [("stack", "dense", cfg.num_layers)]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
FRONTENDS = (None, "patches", "codes")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES or cfg.frontend not in FRONTENDS:
        raise ValueError(
            f"family {cfg.family!r} (frontend={cfg.frontend!r}) is not one "
            f"the model defines: families {FAMILIES}, frontends "
            f"{FRONTENDS}")


# -------------------------------------------------------------------- init
def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random weights with the reference's tree, shapes, dtypes
    and scales (numpy normals, so not the reference's numbers). With
    ``device="meta"`` every leaf has its shape and dtype and nothing is
    drawn (the dry run's shape-only init, at any size)."""
    check_family(cfg)
    dev = resolve_device(device)
    dtype = nn.torch_dtype(cfg.dtype)
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev)}
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.frontend == "codes":
        K = cfg.num_codebooks
        params["embed"] = nn.normal_init(rng, (K, V, d), 0.02, dtype, dev)
        params["heads"] = nn.normal_init(rng, (K, d, V), d ** -0.5, dtype,
                                         dev)
    else:
        params["embed"] = nn.embed_init(rng, V, d, dtype, dev)
        if not cfg.tie_embeddings:
            params["head"] = nn.dense_init(rng, d, V, dtype, dev)
    if cfg.family == "hybrid":
        params["hybrid"] = tfm.hybrid_init(rng, cfg, dtype, dev)
    for key, kind, n in _stacks(cfg):
        params[key] = tfm.stack_init(rng, cfg, n, kind, dtype, dev)
    return params


def params_device(params) -> torch.device:
    return params["embed"].device


# ----------------------------------------------------------------- forward
def _rows(table: torch.Tensor, ids: torch.Tensor, lo: Optional[int]
          ) -> torch.Tensor:
    """``table[ids]``; with ``lo`` the table holds the vocab rows from id
    ``lo`` on (this rank's slice), and an id outside them gives a zero
    row."""
    if lo is None:
        return table[ids.long()]
    local = ids.long() - lo
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, 0)]
    return torch.where(mine[..., None], rows, rows.new_zeros(()))


def _close_rows(x: torch.Tensor, sp: bool, mesh) -> torch.Tensor:
    """The ranks' partial embedding rows summed over 'model' (each row
    has one owner; the others add zeros); with ``sp`` the sum is cut
    along the sequence as it closes (one reduce-scatter). The cotangent
    reaches every rank's partial whole, so the lookup's gradient stays
    on this rank's slice."""
    from repro_torch.parallel import collectives  # noqa: PLC0415
    if sp:
        return collectives.sp_close(x, shd.SEQ_AXIS, 1, mesh)
    return collectives.tp_close(x, "model", mesh)


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor,
           patch_embeds: Optional[torch.Tensor], plan=None,
           sp: bool = False) -> torch.Tensor:
    """(B, S, d) input rows. Audio: the K codebooks' embeddings summed in
    codebook order. Vlm: the patch embeddings prepended when given
    (prefill and training; decode steps pass tokens only).

    Under a ``plan`` whose vocab is cut (:meth:`TrainPlan.vocab_tp`) each
    rank looks up only the ids of its vocab slice (audio: summed over
    the codebooks on the rank) and the partial rows are summed over
    'model' (:func:`_close_rows`). With ``sp`` (sequence parallelism)
    this rank's slice of the sequence is returned: cut as the rows close
    where nothing is prepended, else after the patches are (the
    reference's order)."""
    vocab_cut = plan is not None and plan.vocab_tp(cfg)
    lo = plan.vocab_first(cfg) if vocab_cut else None
    if cfg.frontend == "codes":
        emb = params["embed"]  # (K, V, d): this rank's (K, V / M, d)
        x = torch.zeros((tokens.shape[0], tokens.shape[2], cfg.d_model),
                        dtype=emb.dtype, device=emb.device)
        for k in range(cfg.num_codebooks):
            x = x + _rows(emb[k], tokens[:, k, :], lo)
    else:
        x = _rows(params["embed"], tokens, lo)  # (B, S, d)
    patches = cfg.frontend == "patches" and patch_embeds is not None
    if lo is not None:
        x = _close_rows(x, sp and not patches, plan.mesh)
    if patches:
        x = torch.cat([patch_embeds.to(device=x.device, dtype=x.dtype), x],
                      dim=1)
    if sp and (lo is None or patches):
        from repro_torch.parallel import collectives  # noqa: PLC0415
        x = collectives.seq_split(x, shd.SEQ_AXIS, 1, plan.mesh)
    return x


def _logits(params, cfg: ArchConfig, x: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """f32 logits ``x @ head`` with the head upcast to f32, as in the
    reference, one slice of vocab columns at a time so the f32 copy of a
    low-precision head never exists whole. Audio: (B, S, K, V) from the
    K heads, the reference's f32 ``bskv`` einsum.

    With ``mesh`` the head holds this rank's vocab columns (a plan that
    cuts the vocab) and ``x`` enters with ``tp_open``, so its gradient,
    each rank's share from its own columns, is summed over 'model'."""
    xf = x.float()
    if mesh is not None:
        from repro_torch.parallel import collectives  # noqa: PLC0415
        xf = collectives.tp_open(xf, "model", mesh)
    if cfg.frontend == "codes":
        return torch.einsum("bsd,kdv->bskv", xf, params["heads"].float())
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    if head.dtype == torch.float32:
        return xf @ head
    d, V = head.shape
    step = max(1, HEAD_SLICE_VALUES // d)
    out = torch.empty(x.shape[:-1] + (V,), dtype=torch.float32,
                      device=x.device)
    for c in range(0, V, step):
        out[..., c:c + step] = xf @ head[:, c:c + step].float()
    return out


def _cache_length(cfg: ArchConfig, caches, batch: int, device
                  ) -> torch.Tensor:
    """Per-slot positions already in the caches, (B,) int32: layer 0's
    lengths of ``"stack"`` (the hybrid's first application of its shared
    block); zeros for the ssm family, whose state has no positions."""
    if cfg.family == "ssm":
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family == "hybrid":
        return caches["hybrid"]["attn"].length[0]
    return caches["stack"].length[0]  # stacked over layers -> layer 0: (B,)


def _backbone(params, cfg: ArchConfig, x, positions, caches, active=None,
              block_tables=None, advance=None, attn_kernel="gather",
              continuation=False):
    """The layer stacks; returns (x, new_caches dict or None, aux)."""
    if cfg.family == "hybrid":
        x, nc, aux = tfm.hybrid_fwd(
            params["hybrid"], x, positions, cfg,
            None if caches is None else caches["hybrid"], active=active,
            block_tables=block_tables, advance=advance)
        return x, (None if nc is None else {"hybrid": nc}), aux
    kw = dict(active=active, block_tables=block_tables, advance=advance,
              attn_kernel=attn_kernel, continuation=continuation)
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
            last_only: bool = False, attn_kernel: str = "gather",
            continuation: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], dict]:
    """Full-sequence forward. Returns (logits, new_caches, aux) with aux
    {'loss', 'skip': f32[2] [skipped, total] tile-dots summed over
    layers}. ``last_only`` computes logits at the last (real) position
    only; with ``batch['advance']`` that is row advance-1.

    ``continuation=True`` marks a prefix-cache SUFFIX prefill: the
    caches already hold a prefix (see :func:`paged_prefix_caches`) and
    attention runs the fresh queries over the whole buffer anchored at
    the cache length. Bucketable families only, like ``advance``.

    Under a plan with sequence parallelism (``TrainPlan.seq_parallel``)
    the stacks run on this rank's slice of the sequence: it is cut
    before the first block and gathered after the last, so the final
    norm and the head run on the whole sequence on every model rank.
    Under a plan whose vocab is cut (``TrainPlan.vocab_tp``) each rank
    computes its own vocab columns of the logits, which are then
    gathered whole along the vocab (the weights never are)."""
    logits, new_caches, aux, cut = _forward(
        params, cfg, batch, caches, last_only=last_only,
        attn_kernel=attn_kernel, continuation=continuation)
    if cut is not None:
        from repro_torch.parallel import collectives  # noqa: PLC0415
        logits = collectives.gather_on_use(logits, "model", logits.dim() - 1,
                                           cut.mesh)
    return logits, new_caches, aux


def _forward(params, cfg: ArchConfig, batch, caches=None, *,
             last_only=False, attn_kernel="gather", continuation=False):
    """:func:`forward` with the logits as this rank computes them: its
    vocab columns under a plan whose vocab is cut. Returns (logits,
    new_caches, aux, that plan or None)."""
    check_family(cfg)
    plan = shd.current_plan()
    if plan is not None:
        params = plan.top(params, cfg)  # embed / head gathered unless cut
    cut = plan if plan is not None and plan.vocab_tp(cfg) else None
    tokens, patch_embeds = batch["tokens"], batch.get("patch_embeds")
    B, S = tokens.shape[0], tokens.shape[-1]
    if cfg.frontend == "patches" and patch_embeds is not None:
        S += patch_embeds.shape[1]
    sp = plan is not None and plan.seq_parallel(cfg, S)
    x = _embed(params, cfg, tokens, patch_embeds, plan, sp)
    active = batch.get("active")
    if active is not None:
        x = x * active.to(x.dtype)[:, None, None]
    if caches is not None:
        offset = torch.broadcast_to(
            _cache_length(cfg, caches, B, x.device), (B,))
    else:
        offset = torch.zeros((B,), dtype=torch.int32, device=x.device)
    positions = offset[:, None] + torch.arange(S, device=x.device,
                                               dtype=torch.int32)[None, :]
    advance = batch.get("advance")
    if continuation and cfg.family not in bucketable_families():
        # Same exactness requirement as bucketed prefill: suffix rows are
        # masked-tail padded, and the cached prefix must be position-
        # causal for the continuation to equal the full prefill.
        raise ValueError(
            f"continuation prefill is not supported for family "
            f"{cfg.family!r}")
    if advance is not None and cfg.family not in bucketable_families():
        # Masked-tail prefill is exact only for position-causal stacks;
        # MoE capacity routing is batch-shape dependent.
        raise ValueError(
            f"batch['advance'] (bucketed prefill) is not supported for "
            f"family {cfg.family!r}; prefill at exact length instead")
    x, new_caches, aux = _backbone(
        params, cfg, x, positions, caches, active=active,
        block_tables=batch.get("block_tables"), advance=advance,
        attn_kernel=attn_kernel, continuation=continuation)
    if sp:
        from repro_torch.parallel import collectives  # noqa: PLC0415
        x = collectives.seq_gather(x, shd.SEQ_AXIS, 1)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        if advance is not None:
            li = torch.clamp(advance.to(device=x.device).long() - 1, 0, S - 1)
            x = torch.gather(
                x, 1, li[:, None, None].expand(B, 1, x.shape[-1]))
        else:
            x = x[:, -1:]
    return (_logits(params, cfg, x, None if cut is None else cut.mesh),
            new_caches, aux, cut)


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over the text positions (audio: the mean
    over codebooks of each stream's), weighted by ``batch["loss_mask"]``
    when given, plus the MoE router aux loss. Returns (total, {"loss",
    "aux_loss", "total_loss"})."""
    total, metrics, _ = loss_terms(params, cfg, batch)
    return total, metrics


def _sum_exp(lg: torch.Tensor, m: torch.Tensor, mesh) -> torch.Tensor:
    """sum(exp(lg - m)) over the last dim and over the ranks' vocab
    columns on 'model'."""
    from repro_torch.parallel import collectives  # noqa: PLC0415
    return collectives.tp_close(torch.exp(lg - m[..., None]).sum(-1),
                                "model", mesh)


def _target_logit(lg: torch.Tensor, targets: torch.Tensor, lo: int, mesh
                  ) -> torch.Tensor:
    """``lg[..., targets]`` where ``lg`` holds the vocab columns from id
    ``lo`` on: the rank that holds a target gives its logit, the others
    zero, summed over 'model'."""
    from repro_torch.parallel import collectives  # noqa: PLC0415
    local = targets - lo
    mine = (local >= 0) & (local < lg.shape[-1])
    t = torch.gather(lg, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    return collectives.tp_close(torch.where(mine, t, t.new_zeros(())),
                                "model", mesh)


def _log_prob_at(lg: torch.Tensor, targets: torch.Tensor, cut, cfg
                 ) -> torch.Tensor:
    """log_softmax(lg)[..., targets] over the last dim. Under a plan
    ``cut`` whose vocab is cut, ``lg`` holds this rank's columns and the
    softmax runs over the ranks': the row max over 'model' (no gradient),
    the sum of exps and the target's logit each summed over 'model' with
    the cotangent passed to every rank's partial, so this rank's logits
    get ``softmax - onehot`` on its own columns."""
    if cut is None:
        lse = torch.log_softmax(lg, dim=-1)
        return torch.gather(lse, -1, targets[..., None])[..., 0]
    from repro_torch.parallel import collectives  # noqa: PLC0415
    m = collectives.pmax(lg.detach().amax(-1), "model", cut.mesh)
    se = _sum_exp(lg, m, cut.mesh)
    t = _target_logit(lg, targets, cut.vocab_first(cfg), cut.mesh)
    return (t - m) - torch.log(se)


def loss_terms(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], dict]:
    """:func:`loss_fn` plus the forward's aux record (its skip counters).

    Inside a sharded training step ``batch`` holds this rank's rows: the
    numerator and the denominator of the masked mean are summed over the
    batch axes (never the shards' means, which differ under a mask), so
    every rank gets the global loss; its gradient is the share that the
    step's average of the ranks' gradients turns into the global one.
    Where the plan cuts the vocab, the cross-entropy runs on this rank's
    vocab columns (:func:`_log_prob_at`)."""
    logits, _, aux, cut = _forward(params, cfg, batch)
    tokens = batch["tokens"].long()
    if cfg.frontend == "codes":
        targets = tokens[:, :, 1:]  # (B, K, S-1)
        ll = _log_prob_at(logits[:, :-1], targets.permute(0, 2, 1), cut,
                          cfg)  # (B, S-1, K)
        mask = torch.ones(ll.shape[:2], dtype=torch.float32,
                          device=ll.device)
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"][:, 1:]
        num = -torch.sum(ll.mean(-1) * mask)
    else:
        if cfg.frontend == "patches":
            logits = logits[:, batch["patch_embeds"].shape[1]:]  # text
        ll = _log_prob_at(logits[:, :-1], tokens[:, 1:], cut, cfg)
        mask = torch.ones_like(ll)
        if "loss_mask" in batch:
            mask = batch["loss_mask"][:, 1:].to(ll.dtype)
        num = -torch.sum(ll * mask)
    den = mask.sum()
    plan = shd.current_plan()
    if plan is not None and plan.batch_size > 1:
        from repro_torch.parallel import collectives  # noqa: PLC0415
        den = collectives.psum(den.detach().clone(), plan.batch_axes)
        loss = collectives.psum_replicas(num / torch.clamp_min(den, 1.0),
                                         plan.batch_axes)
    else:
        loss = num / torch.clamp_min(den, 1.0)
    total = loss + aux["loss"]
    return total, {"loss": loss, "aux_loss": aux["loss"],
                   "total_loss": total}, aux


def serving_decode_step(params, cfg: ArchConfig, last_tokens, caches,
                        active, block_tables=None, attn_kernel="gather"):
    """Continuous-batching decode tick. last_tokens: (B, 1) or (B, K, 1)
    for audio; active: f32
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
    """Families whose serving caches are pure attention-KV stacks and can
    be paged (the reference's list). The ssm and hybrid states are
    fixed-size recurrences with no per-token rows to page: they keep the
    contiguous layout."""
    return ("dense", "vlm", "audio", "moe")


def bucketable_families() -> Tuple[str, ...]:
    """Families for which padded-to-bucket prefill is exact: every
    cross-position op is position-causal (the reference's list). MoE is
    out (capacity routing depends on the batch shape), as are ssm and
    hybrid (their recurrent prefill state would absorb padded rows)."""
    return ("dense", "vlm", "audio")


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cuda") -> Dict[str, Any]:
    """Layer-stacked contiguous caches (the contiguous layout's serving
    caches, and the prefill scratch): GQA k/v, MLA latents and rope
    keys, ssm conv windows and states, or the hybrid's tree of both."""
    check_family(cfg)
    dtype, dev = nn.torch_dtype(cfg.dtype), resolve_device(device)
    if cfg.family == "hybrid":
        return {"hybrid": tfm.hybrid_init_caches(cfg, batch, max_len, dtype,
                                                 dev)}
    if cfg.family == "ssm":
        return {"stack": ssm_lib.mamba2_init_cache(
            cfg, batch, dtype, dev, layers=cfg.num_layers)}
    init = mla_init_cache if cfg.mla is not None else gqa_init_cache
    return {key: init(cfg, batch, max_len, dtype, dev, layers=n)
            for key, _, n in _stacks(cfg)}


def prefill(params, cfg: ArchConfig, batch, max_len: int, *,
            last_only: bool = False):
    """Run the prompt through the model into fresh contiguous caches of
    ``max_len`` rows. Returns (logits, caches)."""
    caches = init_caches(cfg, batch["tokens"].shape[0], max_len,
                         device=batch["tokens"].device)
    logits, new_caches, _ = forward(params, cfg, batch, caches,
                                    last_only=last_only)
    return logits, new_caches


def decode_step(params, cfg: ArchConfig, last_tokens, caches):
    """One-token step over contiguous caches. last_tokens: (B, 1) or
    (B, K, 1) for audio."""
    logits, new_caches, _ = forward(params, cfg, {"tokens": last_tokens},
                                    caches)
    return logits, new_caches


def cache_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a cache tree (dicts of cache tuples), in a fixed
    order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in cache_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for f in tree for t in cache_leaves(f)]
    return [tree]


def insert_slot_caches(big, small, slot: int):
    """Admission for the contiguous layout: overwrite slot ``slot``'s
    row of EVERY leaf of ``big`` (k, v, lengths, conv windows, states)
    with the batch=1 tree ``small`` from the same config and row count,
    IN PLACE (the reference donates ``big`` for the same effect), and
    return ``big``. The batch axis of a leaf is the one axis where the
    two shapes differ, with 1 on the small side; equal shapes (one
    slot) replace the leaf whole."""
    for b, s in zip(cache_leaves(big), cache_leaves(small)):
        if b.shape == s.shape:
            b.copy_(s)
            continue
        diff = [i for i, (db, ds) in enumerate(zip(b.shape, s.shape))
                if db != ds]
        if len(b.shape) != len(s.shape) or len(diff) != 1 or (
                s.shape[diff[0]] != 1):
            raise ValueError(
                f"cache leaves differ beyond the batch axis: "
                f"{tuple(b.shape)} vs {tuple(s.shape)}")
        b.narrow(diff[0], slot, 1).copy_(s)
    return big


def init_paged_caches(cfg: ArchConfig, batch: int, num_blocks: int,
                      block_size: int, device="cuda") -> Dict[str, Any]:
    """Pool-backed serving caches: ``num_blocks`` INCLUDES the reserved
    null block 0 (allocatable ids are 1..num_blocks-1). Every layer owns
    its pool; the block tables are shared across layers and stacks."""
    check_family(cfg)
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


def _pool_rows(block_ids: torch.Tensor, rows: torch.Tensor, bs: int
               ) -> torch.Tensor:
    """Flat pool row of each cache row through a block table row; rows
    past the table clamp into its last entry."""
    ids = block_ids.to(rows.device).long()
    return ids[torch.clamp(rows // bs, max=ids.shape[0] - 1)] * bs + rows % bs


def insert_slot_paged_from(big, small, slot: int, block_ids: torch.Tensor,
                           true_len: int, start_row: int):
    """Suffix-aware :func:`insert_slot_paged`: scatter only rows
    ``start_row..`` of the batch=1 cache ``small`` into the pool blocks
    ``block_ids`` names and pin slot ``slot``'s length to ``true_len``,
    IN PLACE. Rows below ``start_row`` are the SHARED prefix, already
    resident in pool blocks other slots may map too: their writes go to
    the null block instead, as do bucket-padding rows past the table, so
    a shared block is never written."""
    for key in big:
        bp, sp = big[key], small[key]
        nb, bs = bp.k.shape[1], bp.k.shape[2]
        S, mb = sp.k.shape[2], block_ids.shape[0]
        p = torch.arange(S, device=bp.k.device)
        ok = (p >= start_row) & (p < mb * bs)
        dest = torch.where(ok, _pool_rows(block_ids, p, bs),
                           torch.zeros_like(p))
        for pool, rows in ((bp.k, sp.k), (bp.v, sp.v)):
            flat = pool.view((pool.shape[0], nb * bs) + tuple(pool.shape[3:]))
            flat[:, dest] = rows[:, 0].to(flat.dtype)
        bp.length[:, slot] = int(true_len)
    return big


def paged_prefix_caches(big, block_ids: torch.Tensor, prefix_len: int,
                        small_len: int) -> Dict[str, Any]:
    """Batch=1 contiguous caches of ``small_len`` rows whose first
    ``prefix_len`` rows are GATHERED from the pool through ``block_ids``:
    the suffix prefill's starting state for prefix-cache admission.
    ``small_len`` is the server's max rows plus its largest bucket, so a
    bucketed suffix behind a near-full prefix never overruns it. Rows at
    or past ``prefix_len`` are exact zeros, as in a fresh cache, and the
    lengths are pinned at ``prefix_len``."""
    out = {}
    for key, bp in big.items():
        L, nb, bs = bp.k.shape[0], bp.k.shape[1], bp.k.shape[2]
        src = _pool_rows(block_ids, torch.arange(prefix_len,
                                                 device=bp.k.device), bs)

        def gather(pool):
            flat = pool.view((L, nb * bs) + tuple(pool.shape[3:]))
            buf = torch.zeros((L, 1, small_len) + tuple(pool.shape[3:]),
                              dtype=pool.dtype, device=pool.device)
            buf[:, 0, :prefix_len] = flat[:, src]
            return buf

        out[key] = KVCache(gather(bp.k), gather(bp.v), torch.full(
            (L, 1), prefix_len, dtype=torch.int32, device=bp.k.device))
    return out


def copy_pool_block(big, dst: int, src: int):
    """Device-side copy-on-write: pool block ``src``'s rows into ``dst``
    across every layer of every stack, IN PLACE (the allocator's side is
    :meth:`BlockAllocator.fork`). Queued on the current stream, so it
    lands before any later work on that stream reads block ``dst``."""
    for bp in big.values():
        bp.k[:, dst] = bp.k[:, src]
        bp.v[:, dst] = bp.v[:, src]
    return big
