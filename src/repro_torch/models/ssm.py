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


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    s, d_in, nheads, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in: 2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, xBC, dt


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


def mamba2_forward(params, x: torch.Tensor, cfg: ArchConfig, *,
                   cache: Optional[SSMCache] = None
                   ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x: (B, L, d). With a cache and L == 1 -> recurrent decode step;
    otherwise the chunked scan (from the cache's conv window when one is
    given; the scan itself always starts from a zero state, as in the
    reference)."""
    s, d_in, nheads, conv_dim = _dims(cfg)
    b, L, _ = x.shape
    G, N, P = s.ngroups, s.d_state, s.head_dim

    zxbcdt = x @ params["in_proj"]
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    dt = F.softplus(dt.float() + params["dt_bias"])

    if cache is None or L > 1:
        conv_state = None if cache is None else cache.conv
        xBC, new_conv = _causal_conv(xBC, params["conv_w"],
                                     params["conv_b"], conv_state)
        xs = xBC[..., :d_in].reshape(b, L, nheads, P)
        B = xBC[..., d_in: d_in + G * N].reshape(b, L, G, N)
        C = xBC[..., d_in + G * N:].reshape(b, L, G, N)
        y, h_last = _ssd_chunked(xs, dt, params["A_log"], B, C,
                                 params["D"], s.chunk)
        new_cache = None
        if cache is not None:
            new_cache = SSMCache(conv=new_conv, h=h_last)
    else:
        # Recurrent decode: h = exp(dt*a) h + dt B x ; y = C.h + D x
        xp = torch.cat([cache.conv.to(xBC.dtype), xBC], dim=1)
        conv_out = (torch.einsum("bwc,wc->bc", xp, params["conv_w"])
                    + params["conv_b"])
        xBC1 = F.silu(conv_out)  # (b, conv_dim)
        new_conv = xp[:, 1:, :]
        xs = xBC1[:, :d_in].reshape(b, nheads, P)
        B = xBC1[:, d_in: d_in + G * N].reshape(b, G, N)
        C = xBC1[:, d_in + G * N:].reshape(b, G, N)
        rep = nheads // G
        Bh = torch.repeat_interleave(B, rep, dim=1).float()  # (b, H, N)
        Ch = torch.repeat_interleave(C, rep, dim=1).float()
        a = -torch.exp(params["A_log"])
        da = dt[:, 0] * a[None, :]  # (b, H)
        h = cache.h * torch.exp(da)[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh * dt[:, 0][..., None], xs.float())
        y = torch.einsum("bhn,bhnp->bhp", Ch, h)
        y = y + xs.float() * params["D"][None, :, None]
        y = y[:, None]  # (b, 1, H, P)
        new_cache = SSMCache(conv=new_conv, h=h)

    y = y.reshape(b, L, d_in).to(x.dtype)
    y = rmsnorm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ params["out_proj"], new_cache


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
