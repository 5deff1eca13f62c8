"""ReLU with the SpRF tile bitmap fused at its writeback.

Port of the TPU kernel ``repro/kernels/relu_bitmap.py:relu_bitmap``:
``y = max(x, 0)`` in x's dtype and one int32 bit per (block_r, block_c)
tile, 1 when no element of the tile is > 0. The producer that writes
the activation reduces each tile to its bit in the same pass, so the
bitmap costs no extra read of the activation (the paper's Sparse Value
Checker at writeback). The CUDA kernel is ``csrc/relu_bitmap.cu``; it
takes any shape: the bit grid is ``ceil(R / block_r) x ceil(C /
block_c)`` and elements past the edge count as 0 (not > 0), so the bits
equal those of the reference's zero-padded operand.

Also the port of ``relu_bitmap.py:relu_bwd_bitmap``, the backward with
the error bitmap fused the same way (:func:`relu_bwd_bitmap`: ``gx =
where(x > 0, g, 0)`` and bit 1 when no element of the gx tile is != 0),
which still takes padded dims only.

:func:`relu_bitmap` and :func:`relu_bwd_bitmap` are the entry points: a
CUDA tensor launches the kernel (counted in ``launches``), a CPU tensor
runs the ``*_plain`` version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# The forward kernel's threads per CTA; the most tiles a CTA takes (their
# flags sit in its shared memory).
RELU_THREADS = 128
RELU_MAX_TILES_PER_CTA = 1024


def _check(x: torch.Tensor, block_r: int, block_c: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"relu_bitmap takes a 2-D x, got {tuple(x.shape)}")
    if block_r < 1 or block_c < 1:
        raise ValueError(f"blocks must be >= 1, got ({block_r}, {block_c})")


def _check_padded(x: torch.Tensor, block_r: int, block_c: int) -> None:
    _check(x, block_r, block_c)
    r, c = x.shape
    if r % block_r or c % block_c:
        raise ValueError(
            f"padded dims required: {tuple(x.shape)} % ({block_r},{block_c})")


def relu_bitmap_grid(rows: int, cols: int, block_r: int, block_c: int,
                     dtype: torch.dtype) -> dict:
    """The forward kernel's launch: the bit grid, the tiles a CTA takes
    side by side in one tile row, and the CTAs (tile rows x bands of
    tiles). A function of the shapes only: a CTA covers the tiles one
    16-byte vector a thread reaches."""
    gr, gc = -(-rows // block_r), -(-cols // block_c)
    per_vector = 16 // torch.empty((), dtype=dtype).element_size()
    tpc = RELU_THREADS * per_vector // (block_r * block_c)
    tpc = max(1, min(tpc, gc, RELU_MAX_TILES_PER_CTA))
    return dict(bits=(gr, gc), tiles_per_cta=tpc, ctas=gr * -(-gc // tpc))


def relu_bitmap_plain(x: torch.Tensor, *, block_r: int, block_c: int):
    """What the kernel computes, in plain PyTorch: ``y = x < 0 ? 0 : x``
    (NaN and -0.0 pass through) and the bits over the zero-padded
    tiles. Returns (y, bits)."""
    _check(x, block_r, block_c)
    y = torch.where(x < 0, torch.zeros_like(x), x)
    r, c = x.shape
    gr, gc = -(-r // block_r), -(-c // block_c)
    live = F.pad(x > 0, (0, gc * block_c - c, 0, gr * block_r - r))
    live = live.reshape(gr, block_r, gc, block_c).any(dim=3).any(dim=1)
    return y, (~live).to(torch.int32)


def relu_bitmap(x: torch.Tensor, *, block_r: int, block_c: int):
    """Returns (relu(x), bits int32 (ceil(R/block_r), ceil(C/block_c))),
    1 == no element > 0. Any R and C: ``ops.relu_with_bitmap`` hands x
    over unpadded and returns y as the kernel wrote it. CUDA tensors
    launch the kernel, CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return relu_bitmap_plain(x, block_r=block_r, block_c=block_c)
    if x.device.type != "cuda":
        raise ValueError(f"relu_bitmap: unsupported device {x.device}")
    _check(x, block_r, block_c)
    dtype_id = _build.check_operands("relu_bitmap", x=x)
    r, c = x.shape
    grid = relu_bitmap_grid(r, c, block_r, block_c, x.dtype)
    y = torch.empty_like(x)
    bits = torch.empty(grid["bits"], dtype=torch.int32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("relu_bitmap", "relu_bitmap",
                         [p, p, p, i, i, i, i, i, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), bits.data_ptr(), r, c, block_r,
             block_c, grid["tiles_per_cta"], dtype_id, stream)
    relu_bitmap.launches += 1
    if err != 0:
        raise RuntimeError(f"relu_bitmap launch failed: cudaError {err}")
    return y, bits


relu_bitmap.launches = 0


def _check_bwd(x: torch.Tensor, g: torch.Tensor, block_r: int,
               block_c: int) -> None:
    _check_padded(x, block_r, block_c)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")


def relu_bwd_bitmap_plain(x: torch.Tensor, g: torch.Tensor, *, block_r: int,
                          block_c: int):
    """What the backward kernel computes, in plain PyTorch. Returns
    (gx, bits): gx in g's dtype, a NaN in g passed where x > 0; bit 1
    when no element of the tile is != 0 (NaN counts, -0.0 does not)."""
    _check_bwd(x, g, block_r, block_c)
    r, c = x.shape
    gx = torch.where(x > 0, g, torch.zeros_like(g))
    t = gx.reshape(r // block_r, block_r, c // block_c, block_c)
    bits = (~(t != 0).any(dim=3).any(dim=1)).to(torch.int32)
    return gx, bits


def relu_bwd_bitmap(x: torch.Tensor, g: torch.Tensor, *, block_r: int,
                    block_c: int):
    """Returns (g * (x > 0) as ``where``, bits int32 (R/block_r,
    C/block_c)), 1 == no element != 0: the error sparsity of the
    backward GEMMs. x and g share dtype and shape; R and C are multiples
    of the blocks (``ops.relu_bwd_with_bitmap`` pads). CUDA tensors
    launch the kernel, CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return relu_bwd_bitmap_plain(x, g, block_r=block_r, block_c=block_c)
    if x.device.type != "cuda":
        raise ValueError(f"relu_bwd_bitmap: unsupported device {x.device}")
    _check_bwd(x, g, block_r, block_c)
    dtype_id = _build.check_operands("relu_bwd_bitmap", x=x, g=g)
    r, c = x.shape
    gx = torch.empty_like(g)
    bits = torch.empty((r // block_r, c // block_c), dtype=torch.int32,
                       device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("relu_bitmap", "relu_bwd_bitmap",
                         [p, p, p, p, i, i, i, i, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), g.data_ptr(), gx.data_ptr(), bits.data_ptr(), r, c,
             block_r, block_c, dtype_id, stream)
    relu_bwd_bitmap.launches += 1
    if err != 0:
        raise RuntimeError(f"relu_bwd_bitmap launch failed: cudaError {err}")
    return gx, bits


relu_bwd_bitmap.launches = 0
