"""ReLU with the SpRF tile bitmap fused at its writeback.

Port of the TPU kernel ``repro/kernels/relu_bitmap.py:relu_bitmap``:
``y = max(x, 0)`` in x's dtype and one int32 bit per (block_r, block_c)
tile, 1 when no element of the tile is > 0. The producer that writes
the activation reduces each tile to its bit in the same pass, so the
bitmap costs no extra read of the activation (the paper's Sparse Value
Checker at writeback). The CUDA kernel is ``csrc/relu_bitmap.cu``.

:func:`relu_bitmap` is the entry point: a CUDA tensor launches the
kernel (counted in ``launches``), a CPU tensor runs
:func:`relu_bitmap_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _check(x: torch.Tensor, block_r: int, block_c: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"relu_bitmap takes a 2-D x, got {tuple(x.shape)}")
    if block_r < 1 or block_c < 1:
        raise ValueError(f"blocks must be >= 1, got ({block_r}, {block_c})")
    r, c = x.shape
    if r % block_r or c % block_c:
        raise ValueError(
            f"padded dims required: {tuple(x.shape)} % ({block_r},{block_c})")


def relu_bitmap_plain(x: torch.Tensor, *, block_r: int, block_c: int):
    """What the kernel computes, in plain PyTorch. Returns (y, bits)."""
    _check(x, block_r, block_c)
    r, c = x.shape
    y = torch.clamp_min(x, 0)
    t = y.reshape(r // block_r, block_r, c // block_c, block_c)
    bits = (~(t > 0).any(dim=3).any(dim=1)).to(torch.int32)
    return y, bits


def relu_bitmap(x: torch.Tensor, *, block_r: int, block_c: int):
    """Returns (relu(x), bits int32 (R/block_r, C/block_c)), 1 == no
    element > 0. R and C must be multiples of the blocks
    (``ops.relu_with_bitmap`` pads). CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    if x.device.type == "cpu":
        return relu_bitmap_plain(x, block_r=block_r, block_c=block_c)
    if x.device.type != "cuda":
        raise ValueError(f"relu_bitmap: unsupported device {x.device}")
    _check(x, block_r, block_c)
    dtype_id = _build.check_operands("relu_bitmap", x=x)
    r, c = x.shape
    y = torch.empty_like(x)
    bits = torch.empty((r // block_r, c // block_c), dtype=torch.int32,
                       device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("relu_bitmap", "relu_bitmap",
                         [p, p, p, i, i, i, i, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), bits.data_ptr(), r, c, block_r,
             block_c, dtype_id, stream)
    relu_bitmap.launches += 1
    if err != 0:
        raise RuntimeError(f"relu_bitmap launch failed: cudaError {err}")
    return y, bits


relu_bitmap.launches = 0
