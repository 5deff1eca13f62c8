"""Gated-GLU SparCE MLP: predict-then-skip for silu/gelu MLPs.

Port of the TPU kernel ``repro/kernels/sparce_glu_mlp.py:
sparce_glu_mlp_fused``: ``y = (act(x @ w_gate) * (x @ w_in)) @ w_out``
with the gate computed first per (row tile, f-stripe) and the SpRF bit
emitted at its writeback, ``bit = all(|act(g)| <= tau)``. A dead tile
skips BOTH weight stripes -- its ``w_in`` columns and its ``w_out`` rows
are never loaded (two-sided skip-before-fetch).

Dims need not be multiples of the blocks: rows past M and columns past
F count as ``act(0) = 0``, which can only vote a tile dead, so the bit
grid ``ceil(M/block_m) x ceil(F/block_f)`` equals the zero-padded
reference's, and nothing is padded (a decode tick's 8 rows are not
copied out to ``block_m``).

The CUDA kernel (``csrc/sparce_glu_mlp.cu``) runs one thread block
cluster per (row group, stripe) on the tensor cores: the gate over the
full K split over the cluster's CTAs by columns, the live flags ORed
through distributed shared memory, and for a live stripe only its
up-projection and its partial down-projection into f32 scratch of
:func:`partial_shape`; a second launch adds the live stripes' partials
in a fixed order.

:func:`sparce_glu_mlp_fused` is the entry point: a CUDA tensor launches
the kernel (counted in ``launches``), a CPU tensor runs
:func:`sparce_glu_mlp_fused_plain`, which likewise slices only the live
stripes so the NaN-poison tests hold for it on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import act_f32

_GLU_ACTS = ("silu", "gelu", "relu", "relu2")
_ACT_IDS = {a: i for i, a in enumerate(_GLU_ACTS)}


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round an f32 tensor through ``dtype`` and back to f32."""
    return t.to(dtype).float()


def _check(x, w_gate, w_in, w_out, block_m, block_f, act, tau):
    if act not in _GLU_ACTS:
        raise ValueError(f"act must be one of {_GLU_ACTS}, got {act!r}")
    if tau < 0.0:
        raise ValueError(f"gate threshold must be >= 0, got {tau}")
    if block_m < 1 or block_f < 1:
        raise ValueError(f"blocks must be >= 1, got block_m={block_m}, "
                         f"block_f={block_f}")
    _, k = x.shape
    kg, fg = w_gate.shape
    k2, fdim = w_in.shape
    f2, _ = w_out.shape
    if not (k == kg == k2 and fdim == fg == f2):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_in {tuple(w_in.shape)}, w_out "
            f"{tuple(w_out.shape)}")


def bit_grid(m: int, fdim: int, *, block_m: int, block_f: int) -> tuple:
    """Shape of the bits: one per (row tile, f-stripe), ragged edges
    included."""
    return (-(-m // block_m), -(-fdim // block_f))


def partial_shape(m: int, fdim: int, n: int, *, block_f: int) -> tuple:
    """The f32 scratch the kernel writes each live stripe's partial
    down-projection to: (stripes, M, N). A function of the shapes only."""
    return (-(-fdim // block_f), m, n)


# ----------------------------------------------------------- plain version
def sparce_glu_mlp_fused_plain(
    x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
    w_out: torch.Tensor, *, block_m: int, block_f: int, act: str = "silu",
    tau: float = 0.0, out_dtype=None,
):
    """What the kernel computes, in plain PyTorch: the gate over every
    stripe (it is the predictor), then per row tile only the LIVE
    stripes' columns of ``w_in`` and rows of ``w_out`` are read, and
    nothing past M or F. Returns (y, bits)."""
    _check(x, w_gate, w_in, w_out, block_m, block_f, act, tau)
    m, _ = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    dt = x.dtype
    nm, nf = bit_grid(m, fdim, block_m=block_m, block_f=block_f)
    xf = x.float()
    g = _round(xf @ w_gate.float(), dt)
    ga = _round(act_f32(g, act), dt)
    # Rows past M and columns past F count as act(0) = 0: dead votes.
    dead = torch.ones((nm * block_m, nf * block_f), dtype=torch.bool,
                      device=x.device)
    dead[:m, :fdim] = ga.abs() <= tau
    bits = dead.reshape(nm, block_m, nf, block_f).all(dim=3).all(dim=1).to(
        torch.int32)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for i in range(nm):
        live = (bits[i] == 0).nonzero().flatten()
        if live.numel() == 0:
            continue
        cols = (live[:, None] * block_f
                + torch.arange(block_f, device=x.device)).flatten()
        cols = cols[cols < fdim]
        rows = slice(i * block_m, (i + 1) * block_m)
        h = _round(xf[rows] @ w_in.index_select(1, cols).float(), dt)
        a = _round(ga[rows][:, cols] * h, dt)
        y[rows] = a @ w_out.index_select(0, cols).float()
    return y.to(out_dtype or dt), bits


# ------------------------------------------------------------- CUDA kernel
def sparce_glu_mlp_fused(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    *,
    block_m: int,
    block_f: int,
    act: str = "silu",
    tau: float = 0.0,
    out_dtype=None,
):
    """(act(x @ w_gate) * (x @ w_in)) @ w_out with two-sided stripe skip.

    x: (M, K); w_gate, w_in: (K, F); w_out: (F, N), any M and F.
    Returns (y (M, N), bits int32 (ceil(M/block_m), ceil(F/block_f))),
    1 == dead tile. CUDA tensors launch the kernel, CPU tensors run the
    plain version.
    """
    if x.device.type == "cpu":
        return sparce_glu_mlp_fused_plain(
            x, w_gate, w_in, w_out, block_m=block_m, block_f=block_f,
            act=act, tau=tau, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sparce_glu_mlp_fused: unsupported device {x.device}")
    _check(x, w_gate, w_in, w_out, block_m, block_f, act, tau)
    dtype_id = _build.check_operands("sparce_glu_mlp_fused", x=x,
                                     w_gate=w_gate, w_in=w_in, w_out=w_out)
    if out_dtype not in (None, x.dtype):
        raise TypeError("the kernel writes y in x's dtype")
    m, k = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    bits = torch.empty(bit_grid(m, fdim, block_m=block_m, block_f=block_f),
                       dtype=torch.int32, device=x.device)
    partial = torch.empty(partial_shape(m, fdim, n, block_f=block_f),
                          dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_glu_mlp", "sparce_glu_mlp",
                         [p] * 7 + [i] * 7 + [ctypes.c_float, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), w_gate.data_ptr(), w_in.data_ptr(), w_out.data_ptr(),
        y.data_ptr(), bits.data_ptr(), partial.data_ptr(),
        m, k, fdim, n, block_m, block_f, _ACT_IDS[act], float(tau),
        dtype_id, stream)
    sparce_glu_mlp_fused.launches += 1
    if err != 0:
        raise RuntimeError(
            f"sparce_glu_mlp_fused launch failed: cudaError {err} (1: the "
            f"tile {block_m}x{block_f} needs more shared memory than a block "
            "has, or a bad argument)")
    return y, bits


sparce_glu_mlp_fused.launches = 0


def kernel_grid(m: int, k: int, fdim: int, n: int, *, block_m: int,
                block_f: int, dtype: torch.dtype) -> dict:
    """The CUDA kernel's launch at these shapes (builds the library):
    CTAs, CTAs per cluster, rows per chunk and dynamic shared memory."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_glu_mlp", "sparce_glu_mlp_grid",
                         [i] * 7 + [p])
    out = (ctypes.c_int * 5)()
    err = fn(m, k, fdim, n, block_m, block_f, _build.DTYPE_IDS[dtype], out)
    if err != 0:
        raise RuntimeError(f"sparce_glu_mlp_grid: cudaError {err}")
    return dict(ctas=out[0] * out[1], grid=(out[0], out[1]),
                cluster=out[2], rows=out[3], smem=out[4])
