"""Fused SparCE MLP for relu-family activations: up-projection,
activation, bitmap at the writeback and gated down-projection in one
kernel.

Port of the TPU kernel ``repro/kernels/sparce_mlp.py:sparce_mlp_fused``:
``y = act(x @ w_in) @ w_out`` for ``act`` in relu / relu2. Per (row
tile, f-stripe) the activated tile is rounded through the input dtype
(as the unfused pipeline's writeback would round it) and reduced to its
SpRF bit, ``bit = all(a == 0)``; a zero tile's ``w_out`` stripe is never
loaded. The ``w_in`` stripe is always read: it produces the bit.

Dims need not be multiples of the blocks: rows past M and columns past
F count as ``a = 0``, which can only vote a tile dead, so the bit grid
``ceil(M/block_m) x ceil(F/block_f)`` equals the zero-padded
reference's, and nothing is padded.

The CUDA kernel (``csrc/sparce_mlp.cu``) runs the gated GLU's thread
block cluster design (``csrc/cluster_mlp.cuh``) with the up-projection
as its first product: the cluster's CTAs split a stripe's columns of
``x @ w_in``, OR the tile flags through distributed shared memory, and
for a live stripe write its partial down-projection to f32 scratch of
:func:`partial_shape`; a second launch adds, per row, the partials of
the stripes live in the row's tile, in a fixed order.

:func:`sparce_mlp_fused` is the entry point: a CUDA tensor launches the
kernel (counted in ``launches``), a CPU tensor runs
:func:`sparce_mlp_fused_plain`, which likewise reads only the live
stripes of ``w_out`` so the NaN-poison tests hold for it on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparce_glu_mlp import bit_grid, partial_shape

ACTS = ("relu", "relu2")


def _check(x, w_in, w_out, block_m, block_f, act):
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if block_m < 1 or block_f < 1:
        raise ValueError(f"blocks must be >= 1, got block_m={block_m}, "
                         f"block_f={block_f}")
    _, k = x.shape
    k2, fdim = w_in.shape
    f2, _ = w_out.shape
    if not (k == k2 and fdim == f2):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w_in {tuple(w_in.shape)}, "
            f"w_out {tuple(w_out.shape)}")


def _activate_rounded(h: torch.Tensor, act: str, dtype) -> torch.Tensor:
    """relu (relu2: squared on the f32 value), rounded through ``dtype``."""
    a = torch.clamp_min(h, 0.0)
    if act == "relu2":
        a = a * a
    return a.to(dtype).float()


def sparce_mlp_fused_plain(
    x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, *,
    block_m: int, block_f: int, act: str = "relu", out_dtype=None,
):
    """What the kernel computes, in plain PyTorch: the up-projection over
    every stripe (it is the producer), then per row tile only the LIVE
    stripes' rows of ``w_out`` are read, and nothing past M or F.
    Returns (y, bits)."""
    _check(x, w_in, w_out, block_m, block_f, act)
    m, _ = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    nm, nf = bit_grid(m, fdim, block_m=block_m, block_f=block_f)
    a = _activate_rounded(x.float() @ w_in.float(), act, x.dtype)
    # Rows past M and columns past F count as a = 0: dead votes.
    dead = torch.ones((nm * block_m, nf * block_f), dtype=torch.bool,
                      device=x.device)
    dead[:m, :fdim] = a == 0
    bits = dead.reshape(nm, block_m, nf, block_f).all(dim=3).all(dim=1).to(
        torch.int32)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    ar = torch.arange(block_f, device=x.device)
    live = (bits == 0).cpu()
    for i in range(nm):
        stripes = live[i].nonzero().flatten().to(x.device)
        if stripes.numel() == 0:
            continue
        cols = (stripes[:, None] * block_f + ar).flatten()
        cols = cols[cols < fdim]
        rows = slice(i * block_m, (i + 1) * block_m)
        y[rows] = a[rows][:, cols] @ w_out.index_select(0, cols).float()
    return y.to(out_dtype or x.dtype), bits


def sparce_mlp_fused(
    x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, *,
    block_m: int, block_f: int, act: str = "relu", out_dtype=None,
):
    """act(x @ w_in) @ w_out with the bitmap at the activation's
    writeback and dead stripes' ``w_out`` rows never loaded.

    x: (M, K); w_in: (K, F); w_out: (F, N), any M and F. Returns (y (M,
    N), bits int32 (ceil(M/block_m), ceil(F/block_f))), 1 == all-zero
    tile. CUDA tensors launch the kernel, CPU tensors run the plain
    version.
    """
    if x.device.type == "cpu":
        return sparce_mlp_fused_plain(
            x, w_in, w_out, block_m=block_m, block_f=block_f, act=act,
            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sparce_mlp_fused: unsupported device {x.device}")
    _check(x, w_in, w_out, block_m, block_f, act)
    dtype_id = _build.check_operands("sparce_mlp_fused", x=x, w_in=w_in,
                                     w_out=w_out)
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
    fn = _build.function("sparce_mlp", "sparce_mlp",
                         [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), y.data_ptr(),
             bits.data_ptr(), partial.data_ptr(), m, k, fdim, n, block_m,
             block_f, int(act == "relu2"), dtype_id, stream)
    sparce_mlp_fused.launches += 1
    if err != 0:
        raise RuntimeError(
            f"sparce_mlp_fused launch failed: cudaError {err} (1: the tile "
            f"{block_m}x{block_f} needs more shared memory than a block "
            "has, or a bad argument)")
    return y, bits


sparce_mlp_fused.launches = 0


def kernel_grid(m: int, k: int, fdim: int, n: int, *, block_m: int,
                block_f: int, dtype: torch.dtype) -> dict:
    """The CUDA kernel's launch at these shapes (builds the library):
    CTAs, CTAs per cluster, rows per chunk and dynamic shared memory."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_mlp", "sparce_mlp_grid", [i] * 7 + [p])
    out = (ctypes.c_int * 5)()
    err = fn(m, k, fdim, n, block_m, block_f, _build.DTYPE_IDS[dtype], out)
    if err != 0:
        raise RuntimeError(f"sparce_mlp_grid: cudaError {err}")
    return dict(ctas=out[0] * out[1], grid=(out[0], out[1]),
                cluster=out[2], rows=out[3], smem=out[4])
