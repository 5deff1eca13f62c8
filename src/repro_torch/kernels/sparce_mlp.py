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

At training row counts (:func:`tall_path`: bf16, (64, 128) tiles, at
least 1024 rows, K at most 640) the kernel's tall path runs instead: a
CTA per (64-row tile, 288 columns of N) computes each stripe's h with
wgmma, sets the tile's bit, and adds the live stripes' down-projection
into y held in registers across the stripes, written once; no scratch
is allocated and no reduction launched.

:func:`sparce_mlp_fused` is the entry point: a CUDA tensor launches the
kernel (counted in ``launches``), a CPU tensor runs
:func:`sparce_mlp_fused_plain`, which likewise reads only the live
stripes of ``w_out`` so the NaN-poison tests hold for it on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparce_gemm import _aligned as _sg_aligned
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


# The tall kernel's geometry (csrc/sparce_mlp.cu, namespace tall_mlp).
TALL_MIN_ROWS = 1024
TALL_BLOCKS = (64, 128)  # (block_m, block_f): a CTA's rows, the stripe
TALL_MAX_K = 640         # x's 64 rows stay in shared memory
TALL_COLS = 288          # columns of y a CTA


def tall_path(m: int, k: int, fdim: int, n: int, *, block_m: int,
              block_f: int, dtype: torch.dtype) -> bool:
    """Whether a call takes the tall path: bf16, the (64, 128) tiles of a
    training step, at least 1024 rows (a dp-2 shard's 2048 and a whole
    batch's 4096 do; the 256-row prefill and decode do not), K at most
    640, and K, F and N multiples of 8 (rows of whole 16-byte units, as
    TMA reads them). A function of the shapes, tiles and dtype only;
    ``csrc/sparce_mlp.cu:tall_mlp::ok`` is its C side."""
    return (dtype == torch.bfloat16
            and (block_m, block_f) == TALL_BLOCKS and m >= TALL_MIN_ROWS
            and 0 < k <= TALL_MAX_K and k % 8 == 0
            and fdim > 0 and fdim % 8 == 0 and n > 0 and n % 8 == 0)


def tall_ok_c(m: int, k: int, fdim: int, n: int, *, block_m: int,
              block_f: int) -> bool:
    """The C side of :func:`tall_path` for a bf16 call (builds the
    library)."""
    i = ctypes.c_int
    fn = _build.function("sparce_mlp", "sparce_mlp_tall_ok", [i] * 6)
    return bool(fn(m, k, fdim, n, block_m, block_f))


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
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tall_path(m, k, fdim, n, block_m=block_m, block_f=block_f,
                 dtype=x.dtype):
        x, w_in, w_out = (_sg_aligned(t) for t in (x, w_in, w_out))
        fn = _build.function("sparce_mlp", "sparce_mlp_tall",
                             [p] * 5 + [i] * 7 + [p])
        err = fn(x.data_ptr(), w_in.data_ptr(), w_out.data_ptr(),
                 y.data_ptr(), bits.data_ptr(), m, k, fdim, n, block_m,
                 block_f, int(act == "relu2"), stream)
        sparce_mlp_fused.tall_launches += 1
    else:
        partial = torch.empty(partial_shape(m, fdim, n, block_f=block_f),
                              dtype=torch.float32, device=x.device)
        fn = _build.function("sparce_mlp", "sparce_mlp",
                             [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p])
        err = fn(x.data_ptr(), w_in.data_ptr(), w_out.data_ptr(),
                 y.data_ptr(), bits.data_ptr(), partial.data_ptr(), m, k,
                 fdim, n, block_m, block_f, int(act == "relu2"), dtype_id,
                 stream)
    sparce_mlp_fused.launches += 1
    if err != 0:
        raise RuntimeError(
            f"sparce_mlp_fused launch failed: cudaError {err} (1: the tile "
            f"{block_m}x{block_f} needs more shared memory than a block "
            "has, or a bad argument)")
    return y, bits


sparce_mlp_fused.launches = 0
sparce_mlp_fused.tall_launches = 0  # of them, on the tall path


def kernel_grid(m: int, k: int, fdim: int, n: int, *, block_m: int,
                block_f: int, dtype: torch.dtype) -> dict:
    """The cluster design's launch at these shapes (builds the library):
    CTAs, CTAs per cluster, rows per chunk and dynamic shared memory.
    Shapes on the tall path (:func:`tall_path`) launch the tall kernel
    instead, a CTA per 64-row tile and 288 columns."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_mlp", "sparce_mlp_grid", [i] * 7 + [p])
    out = (ctypes.c_int * 5)()
    err = fn(m, k, fdim, n, block_m, block_f, _build.DTYPE_IDS[dtype], out)
    if err != 0:
        raise RuntimeError(f"sparce_mlp_grid: cudaError {err}")
    return dict(ctas=out[0] * out[1], grid=(out[0], out[1]),
                cluster=out[2], rows=out[3], smem=out[4])
