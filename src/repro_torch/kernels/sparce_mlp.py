"""Fused SparCE MLP for relu-family activations: up-projection,
activation, bitmap at the writeback and gated down-projection in one
kernel.

Port of the TPU kernel ``repro/kernels/sparce_mlp.py:sparce_mlp_fused``:
``y = act(x @ w_in) @ w_out`` for ``act`` in relu / relu2. Per (row
tile, f-stripe) the activated tile is rounded through the input dtype
(as the unfused pipeline's writeback would round it) and reduced to its
SpRF bit, ``bit = all(a == 0)``; a zero tile's ``w_out`` stripe is never
loaded. The ``w_in`` stripe is always read: it produces the bit.

The CUDA kernel (``csrc/sparce_mlp.cu``) runs in two passes because GPU
thread blocks cannot carry the TPU kernel's accumulator across a
sequential grid: per-tile partial down-projections into f32 scratch,
then a fixed-order reduction over the live stripes.

:func:`sparce_mlp_fused` is the entry point: a CUDA tensor launches the
kernel (counted in ``launches``), a CPU tensor runs
:func:`sparce_mlp_fused_plain`, which likewise reads only the live
stripes of ``w_out`` so the NaN-poison tests hold for it on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ACTS = ("relu", "relu2")
# Shared memory the CUDA kernel stages besides the activated tiles
# (16 x 33 and 32 x 128 f32), and the rows a block covers at least.
_STAGE_FLOATS = 16 * 33 + 32 * 128
_MIN_BLOCK_ROWS = 16
_SMEM_LIMIT = 227 * 1024


def _check(x, w_in, w_out, block_m, block_f, act):
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    m, k = x.shape
    k2, fdim = w_in.shape
    f2, _ = w_out.shape
    if not (k == k2 and fdim == f2):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w_in {tuple(w_in.shape)}, "
            f"w_out {tuple(w_out.shape)}")
    if m % block_m or fdim % block_f:
        raise ValueError(
            f"padded dims required: M={m} % {block_m}, F={fdim} % {block_f}")


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
    stripes' rows of ``w_out`` are read. Returns (y, bits)."""
    _check(x, w_in, w_out, block_m, block_f, act)
    m, _ = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    nm, nf = m // block_m, fdim // block_f
    a = _activate_rounded(x.float() @ w_in.float(), act, x.dtype)
    bits = (a == 0).reshape(nm, block_m, nf, block_f).all(dim=3).all(dim=1)
    bits = bits.to(torch.int32)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    ar = torch.arange(block_f, device=x.device)
    live = (bits == 0).cpu()
    for i in range(nm):
        stripes = live[i].nonzero().flatten().to(x.device)
        if stripes.numel() == 0:
            continue
        cols = (stripes[:, None] * block_f + ar).flatten()
        rows = slice(i * block_m, (i + 1) * block_m)
        y[rows] = a[rows][:, cols] @ w_out.index_select(0, cols).float()
    return y.to(out_dtype or x.dtype), bits


def sparce_mlp_fused(
    x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, *,
    block_m: int, block_f: int, act: str = "relu", out_dtype=None,
):
    """act(x @ w_in) @ w_out with the bitmap at the activation's
    writeback and dead stripes' ``w_out`` rows never loaded.

    x: (M, K); w_in: (K, F); w_out: (F, N); M % block_m == 0 and
    F % block_f == 0 (``ops.sparce_mlp_fused`` pads). Returns
    (y (M, N), bits int32 (M/block_m, F/block_f)), 1 == all-zero tile.
    CUDA tensors launch the kernel, CPU tensors run the plain version.
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
    group = max(1, _MIN_BLOCK_ROWS // block_m)
    smem = 4 * (group * block_m * block_f + _STAGE_FLOATS)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"tile {block_m}x{block_f} needs {smem} bytes of shared memory "
            f"(limit {_SMEM_LIMIT})")
    m, k = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    nm, nf = m // block_m, fdim // block_f
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    bits = torch.empty((nm, nf), dtype=torch.int32, device=x.device)
    partial = torch.empty((nm, nf, block_m, n), dtype=torch.float32,
                          device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_mlp", "sparce_mlp",
                         [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), y.data_ptr(),
             bits.data_ptr(), partial.data_ptr(), m, k, fdim, n, block_m,
             block_f, int(act == "relu2"), dtype_id, stream)
    sparce_mlp_fused.launches += 1
    if err != 0:
        raise RuntimeError(f"sparce_mlp_fused launch failed: cudaError {err}")
    return y, bits


sparce_mlp_fused.launches = 0
