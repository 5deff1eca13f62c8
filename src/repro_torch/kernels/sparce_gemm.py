"""Bitmap-gated block GEMM: the SparCE skip of a matmul's zero tiles.

Port of the TPU kernel ``repro/kernels/sparce_gemm.py:
sparce_gemm_gated``: ``y = x @ w`` with f32 accumulation over k tiles,
cast once to the output dtype, dropping every tile product whose bit is
1 -- the bit of x's ``(block_m, block_k)`` tile ``[i, k]`` (``gate=
"lhs"``) or of w's ``(block_k, block_n)`` tile ``[k, j]`` (``"rhs"``).
The bit decides, not the values. The CUDA kernel
(``csrc/sparce_gemm.cu``) reads the bits before it loads an operand, so
a gated tile is never loaded (the TPU kernel loads it and skips only the
product).

Dims need not be multiples of the blocks: the kernel masks the ragged
edges itself, so the weight is never padded (a padded copy of a
1536 x 576 down-projection per layer per tick is what this avoids). The
bit grids are ``ceil(M/block_m) x ceil(K/block_k)`` (lhs) or
``ceil(K/block_k) x ceil(N/block_n)`` (rhs), and the result equals the
zero-padded product's ``[:M, :N]``.

:func:`sparce_gemm_gated` is the entry point: a CUDA tensor launches the
kernel (counted in ``launches``), a CPU tensor runs
:func:`sparce_gemm_gated_plain`, which likewise indexes only ungated
tiles so the NaN-poison tests hold for it on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

GATES = ("lhs", "rhs")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def bit_grid(m: int, k: int, n: int, *, block_m: int, block_k: int,
             block_n: int, gate: str) -> tuple:
    """Shape of the bit grid the kernel reads for ``gate``."""
    if gate == "lhs":
        return (_ceil_div(m, block_m), _ceil_div(k, block_k))
    return (_ceil_div(k, block_k), _ceil_div(n, block_n))


def _check(x, w, bits, block_m, block_k, block_n, gate):
    if gate not in GATES:
        raise ValueError(f"gate must be one of {GATES}, got {gate!r}")
    if min(block_m, block_k, block_n) < 1:
        raise ValueError("blocks must be >= 1")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    grid = bit_grid(m, k, n, block_m=block_m, block_k=block_k,
                    block_n=block_n, gate=gate)
    if tuple(bits.shape) != grid:
        raise ValueError(f"{gate} bits must be {grid}, got "
                         f"{tuple(bits.shape)}")


def sparce_gemm_gated_plain(
    x: torch.Tensor, w: torch.Tensor, bits: torch.Tensor, *, block_m: int,
    block_k: int, block_n: int, gate: str = "lhs", out_dtype=None,
) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: per row tile (lhs) or
    column tile (rhs), the product over the ungated k tiles only, in
    f32, cast once. Gated tiles of x (lhs) or w (rhs) are never
    indexed, nor are w's k-stripes gated for the whole row tile."""
    _check(x, w, bits, block_m, block_k, block_n, gate)
    m, k = x.shape
    n = w.shape[1]
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    ar = torch.arange(block_k, device=x.device)

    def cols(live_k):
        idx = (live_k[:, None] * block_k + ar).flatten()
        return idx[idx < k]

    live = (bits == 0).cpu()
    if gate == "lhs":
        for i in range(bits.shape[0]):
            ks = cols(live[i].nonzero().flatten().to(x.device))
            if ks.numel():
                rows = slice(i * block_m, (i + 1) * block_m)
                y[rows] = (x[rows].index_select(1, ks).float()
                           @ w.index_select(0, ks).float())
    else:
        for j in range(bits.shape[1]):
            ks = cols(live[:, j].nonzero().flatten().to(x.device))
            if ks.numel():
                cs = slice(j * block_n, (j + 1) * block_n)
                y[:, cs] = (x.index_select(1, ks).float()
                            @ w[:, cs].index_select(0, ks).float())
    return y.to(out_dtype or x.dtype)


def sparce_gemm_gated(
    x: torch.Tensor, w: torch.Tensor, bits: torch.Tensor, *, block_m: int,
    block_k: int, block_n: int, gate: str = "lhs", out_dtype=None,
) -> torch.Tensor:
    """y = x @ w with tile products dropped where bits == 1.

    x: (M, K); w: (K, N); bits: int32 over x's tiles (lhs) or w's (rhs),
    see :func:`bit_grid`. CUDA tensors launch the kernel, CPU tensors
    run the plain version.
    """
    if x.device.type == "cpu":
        return sparce_gemm_gated_plain(
            x, w, bits, block_m=block_m, block_k=block_k, block_n=block_n,
            gate=gate, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sparce_gemm_gated: unsupported device {x.device}")
    _check(x, w, bits, block_m, block_k, block_n, gate)
    dtype_id = _build.check_operands("sparce_gemm_gated", x=x, w=w)
    if out_dtype not in (None, x.dtype):
        raise TypeError("the kernel writes y in x's dtype")
    if bits.device != x.device or bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32 on {x.device}")
    bits = bits.contiguous()
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_gemm", "sparce_gemm_gated",
                         [p, p, p, p, i, i, i, i, i, i, i, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), bits.data_ptr(), y.data_ptr(), m, k,
             n, block_m, block_k, block_n, int(gate == "rhs"), dtype_id,
             stream)
    sparce_gemm_gated.launches += 1
    if err != 0:
        raise RuntimeError(f"sparce_gemm_gated launch failed: cudaError {err}")
    return y


sparce_gemm_gated.launches = 0
