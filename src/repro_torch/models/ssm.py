"""Mamba2 (SSD -- state-space duality) mixer: chunked prefill scan and
O(1)-state recurrent decode. [arXiv:2405.21060]

Port of ``repro/models/ssm.py``. Shapes follow the paper: d_inner =
expand*d_model, heads H = d_inner/P (P = head_dim), state N = d_state,
groups G share the B/C projections. The chunked algorithm computes an
intra-chunk attention-like term plus an inter-chunk state recurrence
(here a Python loop over chunks, the reference's scan), so a prefill
costs O(L) work and a decode step touches only the constant-size state.

The dtype points are the reference's: the input projection runs in the
parameter dtype, ``dt`` is ``softplus(dt_f32 + dt_bias)``, the causal
conv runs in xBC's dtype, the scan in f32, and ``y`` is cast to the
input's dtype before the gate and its norm.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import modules as nn
from repro_torch.models.layers import rmsnorm, rmsnorm_init


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_dim) rolling conv window
    h: torch.Tensor  # (B, H, N, P) f32 ssm state


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.ngroups * s.d_state
    return s, d_in, nheads, conv_dim


def mamba2_init(rng, cfg: ArchConfig, dtype, device):
    """The reference's tree and scales (numpy normals)."""
    s, d_in, nheads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_in + 2 * s.ngroups * s.d_state + nheads
    return {
        "in_proj": nn.dense_init(rng, cfg.d_model, d_in_proj, dtype, device),
        "conv_w": nn.normal_init(rng, (s.d_conv, conv_dim), 0.1, dtype,
                                 device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32,
                               device=device),
        "A_log": torch.zeros((nheads,), dtype=torch.float32, device=device),
        "D": nn.ones_init((nheads,), torch.float32, device),
        "gate_norm": rmsnorm_init(d_in, dtype, device),
        "out_proj": nn.dense_init(rng, d_in, cfg.d_model, dtype, device),
    }


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W, as a sum of W shifted
    products. xBC: (B, L, C); conv_w: (W, C). Returns (silu(out + b),
    the last W-1 input rows: the next call's window)."""
    W = conv_w.shape[0]
    L = xBC.shape[1]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], W - 1, xBC.shape[-1]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)  # (B, L+W-1, C)
    out = xp[:, 0:L, :] * conv_w[0][None, None, :]
    for i in range(1, W):
        out = out + xp[:, i:i + L, :] * conv_w[i][None, None, :]
    new_state = xp[:, -(W - 1):, :]
    return F.silu(out + conv_b), new_state


def _ssd_chunked(x, dt, A_log, B, C, D, chunk: int):
    """SSD scan. x: (b, L, H, P); dt: (b, L, H) f32; B, C: (b, L, G, N).
    Returns (y f32 (b, L, H, P), h_last f32 (b, H, N, P)).

    Intra-chunk quadratic term plus the inter-chunk linear recurrence,
    all in f32. The prompt must be a whole number of chunks (or shorter
    than one); the reference asserts the same and so does this port,
    with the same exception type."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, L)
    nc = L // Q
    if nc * Q != L:
        raise AssertionError((L, Q))
    f32 = torch.float32

    a = -torch.exp(A_log)  # (H,) negative
    da = dt * a[None, None, :]  # (b, L, H)

    xc = x.reshape(b, nc, Q, H, P).to(f32)
    dtc = dt.reshape(b, nc, Q, H)
    dac = da.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, G, N).to(f32)
    Cc = C.reshape(b, nc, Q, G, N).to(f32)

    cum = torch.cumsum(dac, dim=2)  # (b, nc, Q, H)
    total = cum[:, :, -1, :]  # (b, nc, H)

    # Intra-chunk: Y[i] += sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j
    Bh = torch.repeat_interleave(Bc, rep, dim=3)  # (b, nc, Q, H, N)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)
    scores = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    ct = cum.permute(0, 1, 3, 2)  # (b, nc, H, Q)
    diff = ct[..., :, None] - ct[..., None, :]  # (b, nc, H, i, j)
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # Mask BEFORE the exp: anti-causal entries have positive exponents
    # that overflow to inf and would poison the product as inf * 0 = nan.
    decay = torch.exp(torch.where(causal, diff,
                                  torch.full_like(diff, float("-inf"))))
    M = scores * decay
    xdt = xc * dtc[..., None]  # (b, nc, Q, H, P)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xdt)

    # Chunk boundary states: S_c = sum_j exp(total - cum_j) dt_j B_j x_j^T
    w = torch.exp(total[:, :, None, :] - cum)  # (b, nc, Q, H)
    S = torch.einsum("bcjhn,bcjhp->bchnp", Bh * (w * dtc)[..., None], xc)

    # Inter-chunk recurrence: the state entering each chunk.
    h = torch.zeros((b, H, N, P), dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (b, nc, H, N, P)

    # Inter-chunk output: Y[i] += C_i . (exp(cum_i) h_prev)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           Ch * torch.exp(cum)[..., None], h_prev)

    y = (y_intra + y_inter).reshape(b, L, H, P)
    y = y + x.to(f32) * D[None, None, :, None]
    return y, h


class _Heads(NamedTuple):
    """The heads a mixer computes: ``nheads`` heads from head ``h0``,
    reading ``ngroups`` B/C groups from group ``g0`` (all of them, whole,
    off a mesh)."""
    h0: int
    nheads: int
    g0: int
    ngroups: int


def _heads_of(cfg: ArchConfig, h0: int, H: int) -> _Heads:
    """``H`` heads from head ``h0``, and the groups they read
    (``TrainPlan.mixer_tp`` makes them whole groups)."""
    s, _, nheads, _ = _dims(cfg)
    rep = nheads // s.ngroups
    return _Heads(h0, H, h0 // rep, max(1, H // rep))


def _spans(cfg: ArchConfig, heads: _Heads, part: str):
    """(start, length) of the columns ``heads`` read, in the whole
    ``in_proj``'s ``z | x | B | C | dt`` layout (``part="in"``) or the
    conv's ``x | B | C`` (``part="conv"``), in that order."""
    s, d_in, nheads, _ = _dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.ngroups
    hx = (heads.h0 * P, heads.nheads * P)
    g = (heads.g0 * N, heads.ngroups * N)
    xbc = [hx, (d_in + g[0], g[1]), (d_in + G * N + g[0], g[1])]
    if part == "conv":
        return xbc
    return ([hx] + [(d_in + a, n) for a, n in xbc]
            + [(2 * d_in + 2 * G * N + heads.h0, heads.nheads)])


def _take(t: torch.Tensor, spans) -> torch.Tensor:
    """The columns ``spans`` of ``t``'s last dim, concatenated."""
    return torch.cat([t.narrow(-1, a, n) for a, n in spans], dim=-1)


def _open_cols(t: torch.Tensor, axis: str) -> torch.Tensor:
    """A leaf (or product) cut contiguously on its last dim over
    ``axis``, gathered whole: every rank takes other columns of it (its
    heads' z, x and dt, every head's B and C), so its gradient is summed
    over the ranks and cut back to this rank's columns (an all-gather
    whose backward is a reduce-scatter, ``collectives.sp_open``)."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    return collectives.sp_open(t, axis, t.dim() - 1)


def _gate_norm(params, g: torch.Tensor, cfg: ArchConfig, heads: _Heads,
               axis: Optional[str]) -> torch.Tensor:
    """The gated output's RMS norm over the whole d_inner. Under tensor
    parallelism ``g`` holds this rank's heads' channels: the sum of
    squares is summed over ``axis`` (every rank scales its own channels
    by the total, so its gradient is summed too: ``collectives.tp_sum``)
    and the replicated scale is used in this rank's slice (its gradient
    summed once)."""
    if axis is None:
        return rmsnorm(params, g, cfg.norm_eps)
    from repro_torch.parallel import collectives  # noqa: PLC0415

    s, d_in, _, _ = _dims(cfg)
    scale = collectives.tp_open(params["scale"], axis).narrow(
        0, heads.h0 * s.head_dim, heads.nheads * s.head_dim)
    dt = g.dtype
    gf = g.float()
    ss = collectives.tp_sum(torch.sum(gf * gf, dim=-1, keepdim=True), axis)
    return (gf * torch.rsqrt(ss / d_in + cfg.norm_eps) * scale).to(dt)


def _tp_project(params, x: torch.Tensor, cfg: ArchConfig, heads: _Heads,
                axis: str, window: bool):
    """Under tensor parallelism: (this rank's heads' z | x | B | C | dt
    columns of ``x @ in_proj``, and when ``window`` the whole x | B | C
    channels of x's last d_conv - 1 rows, equal on every rank: the next
    conv window's).

    ``in_proj`` is stored cut contiguously over its concatenated
    columns, so a rank's stored slice is not its heads' columns. Where
    the rows multiplied are fewer than d_model, the product by the
    stored slice is gathered (rows x columns moved); else the weight is
    gathered (d_model x columns) and its heads' columns taken. Either
    gather's gradient is summed before it is cut to the stored slice."""
    s, d_in, _, conv_dim = _dims(cfg)
    W = params["in_proj"]
    spans = _spans(cfg, heads, "in")
    if x.shape[0] * x.shape[1] < x.shape[-1]:
        whole = _open_cols(x @ W, axis)
        tail = whole[:, -(s.d_conv - 1):, d_in:d_in + conv_dim]
        return _take(whole, spans), tail if window else None
    W = _open_cols(W, axis)
    tail = None
    if window:
        k = min(x.shape[1], s.d_conv - 1)
        tail = x[:, -k:] @ W[:, d_in:d_in + conv_dim]
    return x @ _take(W, spans), tail


def mamba2_forward(params, x: torch.Tensor, cfg: ArchConfig, *,
                   cache: Optional[SSMCache] = None, seq: bool = False,
                   heads: Optional[Tuple[int, int]] = None
                   ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x: (B, L, d). With a cache and L == 1 -> recurrent decode step;
    otherwise the chunked scan (from the cache's conv window when one is
    given; the scan itself always starts from a zero state, as in the
    reference).

    With ``cfg.tp_axis`` (a sharded training step's plan,
    ``TrainPlan.mixer_tp``) the mixer runs ``heads``, (first head,
    heads) of this rank (``TrainPlan.mixer_heads``), on its stored
    slices: ``dt_bias``/``A_log``/``D`` and ``out_proj``'s rows
    as stored, the columns of ``in_proj`` and the conv its heads read
    gathered (:func:`_tp_project`), the gated norm's sum of squares
    summed over the axis, and ``out_proj``'s partial sum closed like
    tensor-parallel attention's (``seq``: on this rank's slice of the
    sequence, opened with an all-gather and closed with a
    reduce-scatter). The cache's ``h`` holds this rank's heads where
    ``cache_spec`` cuts it over the axis (else the heads are gathered
    whole after the step); its conv window stays whole, equal on every
    rank."""
    s, d_in, nheads, conv_dim = _dims(cfg)
    G, N, P = s.ngroups, s.d_state, s.head_dim
    axis = cfg.tp_axis
    if axis is None:
        own = _Heads(0, nheads, 0, G)
    else:
        from repro_torch.parallel import collectives  # noqa: PLC0415

        own = _heads_of(cfg, *heads)
        x = (collectives.sp_open(x, axis, 1) if seq
             else collectives.tp_open(x, axis))
    b, L, _ = x.shape
    H, Gl = own.nheads, own.ngroups
    dl = H * P  # the heads' channels of d_inner

    if axis is None:
        zxbcdt = x @ params["in_proj"]
        conv_w, conv_b = params["conv_w"], params["conv_b"]
        conv_state = None if cache is None else cache.conv
    else:
        zxbcdt, tail = _tp_project(params, x, cfg, own, axis,
                                   cache is not None)
        cspans = _spans(cfg, own, "conv")
        conv_w = _take(_open_cols(params["conv_w"], axis), cspans)
        conv_b = _take(_open_cols(params["conv_b"], axis), cspans)
        conv_state = None if cache is None else _take(cache.conv, cspans)
    state_in = None if cache is None else cache.h
    if state_in is not None and state_in.shape[1] != H:
        # cache_spec keeps h whole over the axis (the hybrid's grouped
        # states at batch 1): this rank's heads of it.
        state_in = state_in.narrow(1, own.h0, H)
    z = zxbcdt[..., :dl]
    xBC = zxbcdt[..., dl: 2 * dl + 2 * Gl * N]
    dt = F.softplus(zxbcdt[..., 2 * dl + 2 * Gl * N:].float()
                    + params["dt_bias"])

    if cache is None or L > 1:
        xBC, new_conv = _causal_conv(xBC, conv_w, conv_b, conv_state)
        xs = xBC[..., :dl].reshape(b, L, H, P)
        B = xBC[..., dl: dl + Gl * N].reshape(b, L, Gl, N)
        C = xBC[..., dl + Gl * N:].reshape(b, L, Gl, N)
        y, h_last = _ssd_chunked(xs, dt, params["A_log"], B, C,
                                 params["D"], s.chunk)
        new_cache = None
        if cache is not None:
            new_cache = SSMCache(conv=new_conv, h=h_last)
    else:
        # Recurrent decode: h = exp(dt*a) h + dt B x ; y = C.h + D x
        xp = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
        conv_out = torch.einsum("bwc,wc->bc", xp, conv_w) + conv_b
        xBC1 = F.silu(conv_out)  # (b, conv channels)
        new_conv = xp[:, 1:, :]
        xs = xBC1[:, :dl].reshape(b, H, P)
        B = xBC1[:, dl: dl + Gl * N].reshape(b, Gl, N)
        C = xBC1[:, dl + Gl * N:].reshape(b, Gl, N)
        rep = H // Gl
        Bh = torch.repeat_interleave(B, rep, dim=1).float()  # (b, H, N)
        Ch = torch.repeat_interleave(C, rep, dim=1).float()
        a = -torch.exp(params["A_log"])
        da = dt[:, 0] * a[None, :]  # (b, H)
        h = state_in * torch.exp(da)[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh * dt[:, 0][..., None], xs.float())
        y = torch.einsum("bhn,bhnp->bhp", Ch, h)
        y = y + xs.float() * params["D"][None, :, None]
        y = y[:, None]  # (b, 1, H, P)
        new_cache = SSMCache(conv=new_conv, h=h)
    if axis is not None and new_cache is not None:
        # The whole window, from the rows every rank holds whole; a state
        # the layout keeps whole over the axis gets every rank's heads.
        window = torch.cat([cache.conv.to(tail.dtype), tail], dim=1)
        h = new_cache.h
        if cache.h.shape[1] != H:
            h = collectives.all_gather(h.contiguous(), axis, dim=1)
        new_cache = SSMCache(conv=window[:, -(s.d_conv - 1):], h=h)

    y = y.reshape(b, L, dl).to(x.dtype)
    y = _gate_norm(params["gate_norm"], y * F.silu(z), cfg, own, axis)
    y = y @ params["out_proj"]
    if axis is not None:
        y = (collectives.sp_close(y, axis, 1) if seq
             else collectives.tp_close(y, axis))
    return y, new_cache


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype, device,
                      layers: int = 1) -> SSMCache:
    """Layer-stacked zero state: conv (layers, batch, d_conv-1,
    conv_dim) in the model dtype, h (layers, batch, H, N, P) f32."""
    s, d_in, nheads, conv_dim = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((layers, batch, s.d_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        h=torch.zeros((layers, batch, nheads, s.d_state, s.head_dim),
                      dtype=torch.float32, device=device),
    )
