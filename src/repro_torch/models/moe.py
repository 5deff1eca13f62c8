"""Mixture-of-Experts with sort-based (grouped-GEMM style) dispatch.

Port of the global path of ``repro/models/moe.py``: top-k routing ->
stable sort by expert id -> scatter into a static (E, C, d) buffer ->
per-expert GEMMs (``torch.bmm``, as the reference leaves its einsums to
the compiler) -> gate-weighted combine. The expert-parallel shard_map
path of the reference waits for the multi-device port; :func:`moe_forward`
runs the global path.

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


def moe_forward(params, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss, slot_sparsity); the global path."""
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
