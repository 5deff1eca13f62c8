"""Mixture-of-Experts with sort-based (grouped-GEMM style) dispatch.

Port of ``repro/models/moe.py``: top-k routing -> stable sort by expert
id -> scatter into a static (E, C, d) buffer -> per-expert GEMMs
(``torch.bmm``, as the reference leaves its einsums to the compiler) ->
gate-weighted combine. :func:`moe_forward` takes the expert-parallel
path (:func:`_moe_forward_ep`, the reference's shard_map body) inside a
sharded training step whose plan makes it legal, else the global path.

Routing follows the reference exactly, ties included: the reference's
``top_k`` puts the lower expert index first among equal probabilities (a dead
serving slot's zeroed residual stream gives all-equal router logits on
every tick), so the top k come from a stable descending sort. The
dropping scatter writes dropped assignments into a spare row ``E * C``
that is cut off afterwards.

The combine is deterministic: instead of an unordered scatter-add (an
atomic ``index_add_`` on the GPU), each token's K gathered expert rows
are summed in a fixed order -- ascending expert id, starting from
zeros, the order in which the reference's sorted scatter-add visits
them -- so a run gives the same bits every time on every device.

Capacity-factor dropping makes outputs batch-dependent (an assignment
dropped in a long prefill survives a one-token decode pass); decode and
full forward agree only in the drop-free regime.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import modules as nn
from repro_torch.parallel import sharding as shd


def moe_init(rng, cfg: ArchConfig, dtype, device):
    """The reference's tree: router (d, E), expert w_in/w_gate (E, d, de)
    and w_out (E, de, d), and a ``shared`` GLU expert when configured."""
    m = cfg.moe
    d = cfg.d_model
    de = m.d_expert or cfg.d_ff
    E = m.num_experts
    p = {
        "router": nn.dense_init(rng, d, E, dtype, device, scale=0.02),
        "w_in": nn.normal_init(rng, (E, d, de), d ** -0.5, dtype, device),
        "w_gate": nn.normal_init(rng, (E, d, de), d ** -0.5, dtype, device),
        "w_out": nn.normal_init(rng, (E, de, d), de ** -0.5, dtype, device),
    }
    if m.n_shared_experts:
        ff_sh = de * m.n_shared_experts
        p["shared"] = {
            "w_in": nn.dense_init(rng, d, ff_sh, dtype, device),
            "w_gate": nn.dense_init(rng, d, ff_sh, dtype, device),
            "w_out": nn.dense_init(rng, ff_sh, d, dtype, device),
        }
    return p


def capacity(num_tokens: int, cfg: ArchConfig) -> int:
    """Per-expert buffer rows: truncated, rounded up to a multiple of 8,
    at least 8 (the reference's)."""
    m = cfg.moe
    c = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def route(xf: torch.Tensor, router: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (T, E) f32, gates (T, K) renormalised, idx (T, K) int64):
    the top k of each row by probability, lower expert index first on
    ties (a stable descending sort)."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = order[:, :top_k]
    gates = torch.gather(probs, 1, idx)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def dispatch(idx: torch.Tensor, C: int, E: int):
    """Sort-based dispatch of the (T, K) assignments. Returns (order,
    st, keep, slot): ``order`` sorts the flattened assignments by expert
    (stable), ``st`` their tokens, ``keep`` whether each fits its
    expert's C rows, ``slot`` its buffer row (``E * C`` when dropped)."""
    T, K = idx.shape
    dev = idx.device
    flat_e = idx.reshape(T * K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = flat_t[order]
    # Position of each assignment within its expert segment.
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * K, device=dev) - first
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    return order, st, keep, slot


def moe_forward(params, x: torch.Tensor, cfg: ArchConfig, seq: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss, slot_sparsity).

    Inside a sharded training step (an ambient plan) whose batch is cut
    over the data axes: the expert-parallel path when the model axis
    (> 1) divides the experts, else the same body with every expert on
    every rank (routing per batch shard). Otherwise the global path.
    ``seq``: ``x`` is this rank's slice of the sequence over 'model'
    (sequence parallelism; the expert-parallel path only)."""
    plan = shd.current_plan()
    if plan is not None:
        kind, M = plan.moe_groups(cfg)
        if kind != "global":
            return _moe_forward_ep(params, x, cfg, plan, M, seq)
    return _moe_forward_global(params, x, cfg)


def _moe_forward_global(params, x: torch.Tensor, cfg: ArchConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    C = capacity(T, cfg)
    xf = x.reshape(T, d)

    probs, gates, idx = route(xf, params["router"], K)
    # Load-balancing aux loss (Switch/GShard form).
    me = probs.mean(dim=0)  # (E,)
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    aux = E * (me * ce).sum() * m.router_aux_weight

    # ---- sort-based dispatch into (E, C, d); row E*C catches drops ----
    order, st, keep, slot = dispatch(idx, C, E)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xf[st]
    buf = buf[:E * C].reshape(E, C, d)

    # ---- expert GEMMs (grouped) ----
    h = torch.bmm(buf, params["w_in"])
    g = torch.bmm(buf, params["w_gate"])
    a = F.silu(g.float()).to(h.dtype) * h
    ye = torch.bmm(a, params["w_out"]).reshape(E * C, d)

    # ---- combine, in a fixed order ----
    # Back from sorted order to (T, K) assignment order, then each
    # token's K rows by ascending expert id.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=x.device)
    keep_tk = keep[inv].reshape(T, K)
    slot_tk = slot[inv].reshape(T, K)
    rows = ye[torch.clamp_max(slot_tk, E * C - 1)]  # (T, K, d)
    gathered = torch.where(keep_tk[..., None], rows,
                           torch.zeros((), dtype=ye.dtype, device=x.device))
    gathered = (gathered * gates[..., None].to(ye.dtype)).to(x.dtype)
    by_expert = torch.argsort(idx, dim=1)
    gathered = torch.gather(gathered, 1,
                            by_expert[..., None].expand(T, K, d))
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        y = y + gathered[:, k]

    if m.n_shared_experts:
        sh = params["shared"]
        hs = xf @ sh["w_in"]
        gs = F.silu((xf @ sh["w_gate"]).float())
        y = y + (gs.to(hs.dtype) * hs) @ sh["w_out"]

    # Structural-sparsity accounting: the unoccupied share of the (E*C)
    # buffer rows, the tile-bitmap sparsity a gated expert GEMM skips.
    occupancy = keep.float().sum() / (E * C)
    return y.reshape(B, S, d), aux, 1.0 - occupancy


# ------------------------------------------------- expert-parallel (EP)
def _combine(ye, keep_tk, slot_tk, gates, idx, T: int, d: int, dtype):
    """Each token's K expert rows, gate-weighted, summed by ascending
    expert id from zeros (dropped and other ranks' rows are zeros)."""
    K = idx.shape[1]
    rows = ye[torch.clamp_max(slot_tk, ye.shape[0] - 1)]  # (T, K, d)
    gathered = torch.where(keep_tk[..., None], rows,
                           torch.zeros((), dtype=ye.dtype, device=ye.device))
    gathered = (gathered * gates[..., None].to(ye.dtype)).to(dtype)
    by_expert = torch.argsort(idx, dim=1)
    gathered = torch.gather(gathered, 1,
                            by_expert[..., None].expand(T, K, d))
    y = torch.zeros((T, d), dtype=dtype, device=ye.device)
    for k in range(K):
        y = y + gathered[:, k]
    return y


def _moe_forward_ep(params, x: torch.Tensor, cfg: ArchConfig, plan, M: int,
                    seq: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's shard_map body on this rank. ``x`` is the rank's
    batch shard, whole over 'model'; the rank's expert slice is
    ``E / M`` experts (M = 1: every expert). Each (data i, model j)
    rank routes its own tokens to its own experts with capacity
    ``capacity(T_loc)`` per expert and token shard, so dispatch needs no
    communication; ONE psum over 'model' closes the routed and shared
    outputs. ``me``/``ce`` are averaged over the batch axes, so the aux
    loss is the global batch's; the occupancy is averaged over 'model'
    and the batch axes.

    Gradients: the ranks of 'model' use ``x`` and the router for their
    own experts, so both open with ``tp_open`` (summed once over
    'model'); the aux loss, alike on every rank of 'model', hands each
    1/M of its cotangent. A shared expert whose hidden width divides by
    M is this rank's TP slice; otherwise it is whole on every rank,
    scaled by 1/M for the closing psum, and its weights' gradients are
    summed over 'model'.

    Under sequence parallelism (``seq``, M > 1) ``x`` is this
    rank's slice of the sequence: the tokens open with an all-gather
    (``sp_open``) in place of ``tp_open`` and ``y`` closes with a
    reduce-scatter (``sp_close``) in place of the psum, so routing,
    capacity and drops see the same tokens."""
    from repro_torch.parallel import collectives as col  # noqa: PLC0415

    m = cfg.moe
    sp = M > 1 and seq
    if sp:
        x = col.sp_open(x, "model", 1)
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    E_loc = E // M
    T = B * S
    C = capacity(T, cfg)
    axes = plan.batch_axes
    n_b = plan.batch_size
    j = plan.mesh.coord("model") if M > 1 else 0
    e0 = j * E_loc

    xf = x.reshape(T, d)
    router = params["router"]
    if M > 1:
        if not sp:
            xf = col.tp_open(xf, "model")
        router = col.tp_open(router, "model")
    probs, gates, idx = route(xf, router, K)

    # Aux loss over ALL tokens: the batch shards' means averaged.
    me = probs.mean(dim=0)
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    if n_b > 1:
        me = col.psum_replicas(me, axes) / n_b
        ce = col.psum(ce.clone(), axes) / n_b
    aux = E * (me * ce).sum() * m.router_aux_weight
    aux = col.grad_scale(aux, 1.0 / M)

    # Local dispatch: only the assignments to this rank's experts;
    # the others sort last and drop.
    flat_e = idx.reshape(T * K) - e0
    local = (flat_e >= 0) & (flat_e < E_loc)
    key_e = torch.where(local, flat_e, torch.full_like(flat_e, E_loc))
    order = torch.argsort(key_e, stable=True)
    se = key_e[order]
    st = torch.arange(T, device=x.device).repeat_interleave(K)[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * K, device=x.device) - first
    keep = (se < E_loc) & (pos < C)
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E_loc * C))
    buf = torch.zeros((E_loc * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xf[st]
    buf = buf[:E_loc * C].reshape(E_loc, C, d)

    h = torch.bmm(buf, params["w_in"])
    g = torch.bmm(buf, params["w_gate"])
    a = F.silu(g.float()).to(h.dtype) * h
    ye = torch.bmm(a, params["w_out"]).reshape(E_loc * C, d)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=x.device)
    y = _combine(ye, keep[inv].reshape(T, K), slot[inv].reshape(T, K),
                 gates, idx, T, d, x.dtype)

    if m.n_shared_experts:
        sh = params["shared"]
        w_in, w_gate, w_out = sh["w_in"], sh["w_gate"], sh["w_out"]
        ff_sh = (m.d_expert or cfg.d_ff) * m.n_shared_experts
        split = M > 1 and ff_sh % M == 0
        if M > 1 and not split:
            w_in, w_gate, w_out = (col.tp_open(w, "model")
                                   for w in (w_in, w_gate, w_out))
        hs = xf @ w_in
        gs = F.silu((xf @ w_gate).float())
        ys = (gs.to(hs.dtype) * hs) @ w_out
        if M > 1 and not split:
            ys = ys * (1.0 / M)  # the psum sums M copies to one
        y = y + ys

    y = y.reshape(B, S, d)
    if sp:
        y = col.sp_close(y, "model", 1)
    elif M > 1:
        y = col.tp_close(y, "model")

    with torch.no_grad():
        occ = keep.float().sum() / (E_loc * C)
        if M > 1:
            occ = col.psum(occ.reshape(1), "model")[0] / M
        if n_b > 1:
            occ = col.psum(occ.reshape(1).clone(), axes)[0] / n_b
    return y, aux, 1.0 - occ
