"""ReLU, and its backward, with the SpRF tile bitmap fused at the
writeback.

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
where(x > 0, g, 0)`` and bit 1 when no element of the gx tile is != 0).
Both are one kernel body over the element operation, with the same
launch (:func:`relu_bitmap_grid`), so the backward takes any shape too
and elements past the edge count as 0 (not != 0).

:func:`relu_bitmap` and :func:`relu_bwd_bitmap` are the entry points: a
CUDA tensor launches the kernel (counted in ``launches``), a CPU tensor
runs the ``*_plain`` version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# The kernel's threads per CTA; the most tiles a CTA takes (their flags
# sit in its shared memory).
RELU_THREADS = 128
RELU_MAX_TILES_PER_CTA = 1024


def _check(x: torch.Tensor, block_r: int, block_c: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"relu_bitmap takes a 2-D x, got {tuple(x.shape)}")
    if block_r < 1 or block_c < 1:
        raise ValueError(f"blocks must be >= 1, got ({block_r}, {block_c})")


def relu_bitmap_grid(rows: int, cols: int, block_r: int, block_c: int,
                     dtype: torch.dtype) -> dict:
    """The kernel's launch (relu and its backward): the bit grid, the
    tiles a CTA takes side by side in one tile row, the rows of a tile
    it takes, and the CTAs (tile rows x slabs x bands of tiles). A
    function of the shapes only: a CTA covers the elements one 16-byte
    vector a thread reaches, several whole tiles when a tile is smaller,
    else a slab of one tile's rows (``rows_per_cta < block_r``: the tile's
    bit gathers across slabs, so the bits start at 1)."""
    gr, gc = -(-rows // block_r), -(-cols // block_c)
    per_vector = 16 // torch.empty((), dtype=dtype).element_size()
    per_cta = RELU_THREADS * per_vector
    tpc = max(1, min(per_cta // (block_r * block_c), gc,
                     RELU_MAX_TILES_PER_CTA))
    rpc = (block_r if block_r * block_c <= per_cta
           else max(1, per_cta // block_c))
    return dict(bits=(gr, gc), tiles_per_cta=tpc, rows_per_cta=rpc,
                ctas=gr * -(-block_r // rpc) * -(-gc // tpc))


def _launch(name: str, fn, x: torch.Tensor, g, y: torch.Tensor,
            block_r: int, block_c: int, dtype_id: int) -> torch.Tensor:
    """Launch entry ``name`` on x (and g) into y; returns the bits."""
    r, c = x.shape
    grid = relu_bitmap_grid(r, c, block_r, block_c, x.dtype)
    split = grid["rows_per_cta"] < block_r
    bits = (torch.ones if split else torch.empty)(
        grid["bits"], dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr()] + ([] if g is None else [g.data_ptr()])
    err = fn(*ptrs, y.data_ptr(), bits.data_ptr(), r, c, block_r, block_c,
             grid["tiles_per_cta"], grid["rows_per_cta"], dtype_id, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return bits


def relu_bitmap_plain(x: torch.Tensor, *, block_r: int, block_c: int):
    """What the kernel computes, in plain PyTorch: ``y = x < 0 ? 0 : x``
    (NaN and -0.0 pass through) and the bits over the zero-padded
    tiles. Returns (y, bits)."""
    _check(x, block_r, block_c)
    y = torch.where(x < 0, torch.zeros_like(x), x)
    return y, _dead_tiles(x > 0, block_r, block_c)


def _dead_tiles(live: torch.Tensor, block_r: int, block_c: int
                ) -> torch.Tensor:
    """int32 bits over the (block_r, block_c) tiles of a bool map, 1 where
    no element is True; the edge padded with False."""
    r, c = live.shape
    gr, gc = -(-r // block_r), -(-c // block_c)
    live = F.pad(live, (0, gc * block_c - c, 0, gr * block_r - r))
    live = live.reshape(gr, block_r, gc, block_c).any(dim=3).any(dim=1)
    return (~live).to(torch.int32)


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
    y = torch.empty_like(x)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("relu_bitmap", "relu_bitmap",
                         [p, p, p, i, i, i, i, i, i, i, p])
    relu_bitmap.launches += 1
    bits = _launch("relu_bitmap", fn, x, None, y, block_r, block_c, dtype_id)
    return y, bits


relu_bitmap.launches = 0


def _check_bwd(x: torch.Tensor, g: torch.Tensor, block_r: int,
               block_c: int) -> None:
    _check(x, block_r, block_c)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")


def relu_bwd_bitmap_plain(x: torch.Tensor, g: torch.Tensor, *, block_r: int,
                          block_c: int):
    """What the backward kernel computes, in plain PyTorch. Returns
    (gx, bits): gx in g's dtype, a NaN in g passed where x > 0; bit 1
    when no element of the tile is != 0 (NaN counts, -0.0 does not) over
    the zero-padded tiles."""
    _check_bwd(x, g, block_r, block_c)
    gx = torch.where(x > 0, g, torch.zeros_like(g))
    return gx, _dead_tiles(gx != 0, block_r, block_c)


def relu_bwd_bitmap(x: torch.Tensor, g: torch.Tensor, *, block_r: int,
                    block_c: int):
    """Returns (g * (x > 0) as ``where``, bits int32 (ceil(R/block_r),
    ceil(C/block_c))), 1 == no element != 0: the error sparsity of the
    backward GEMMs. x and g share dtype and shape; any R and C
    (``ops.relu_bwd_with_bitmap`` hands them over unpadded). CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return relu_bwd_bitmap_plain(x, g, block_r=block_r, block_c=block_c)
    if x.device.type != "cuda":
        raise ValueError(f"relu_bwd_bitmap: unsupported device {x.device}")
    _check_bwd(x, g, block_r, block_c)
    dtype_id = _build.check_operands("relu_bwd_bitmap", x=x, g=g)
    gx = torch.empty_like(g)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("relu_bitmap", "relu_bwd_bitmap",
                         [p, p, p, p, i, i, i, i, i, i, i, p])
    relu_bwd_bitmap.launches += 1
    bits = _launch("relu_bwd_bitmap", fn, x, g, gx, block_r, block_c,
                   dtype_id)
    return gx, bits


relu_bwd_bitmap.launches = 0
