"""Bitmap-gated block GEMMs: the SparCE skip of a matmul's zero tiles.

Ports of the three TPU kernels of ``repro/kernels/sparce_gemm.py``:
:func:`sparce_gemm_gated` (below), :func:`sparce_gemm_compacted` (the
same product under an lhs gate, walking only each row tile's nonzero k
tiles) and :func:`sparce_gemm_gated_both` (a tile product dropped when
either operand's bit is 1), all in ``csrc/sparce_gemm.cu``.

``sparce_gemm_gated``: ``y = x @ w`` with f32 accumulation over k tiles,
cast once to the output dtype, dropping every tile product whose bit is
1 -- the bit of x's ``(block_m, block_k)`` tile ``[i, k]`` (``gate=
"lhs"``) or of w's ``(block_k, block_n)`` tile ``[k, j]`` (``"rhs"``).
The bit decides, not the values. The CUDA kernel
(``csrc/sparce_gemm.cu``) reads the bits before it loads an operand, so
a gated tile is never loaded (the TPU kernel loads it and skips only the
product).

Dims need not be multiples of the blocks: the kernels mask the ragged
edges themselves, so the weight is never padded (a padded copy of a
1536 x 576 down-projection per layer per tick is what this avoids). The
bit grids are ``ceil(M/block_m) x ceil(K/block_k)`` (lhs) or
``ceil(K/block_k) x ceil(N/block_n)`` (rhs), and the result equals the
zero-padded product's ``[:M, :N]``.

Each of the three functions is an entry point: a CUDA tensor launches
its kernel (counted in its ``launches``), a CPU tensor runs its
``*_plain`` version, which likewise indexes only ungated tiles so the
NaN-poison tests hold for it on the CPU.

All three kernels split K: each block sums one fixed chunk of
:func:`chunk_tiles` k tiles, and with more than one chunk the chunks'
f32 partials (scratch of :func:`partial_shape`, allocated here) are
added in ascending chunk order by a second launch inside the same C
call. The chunks depend on ``(K, block_k)`` only, the same for every
kernel, which is what keeps the gated and compacted outputs equal bit
for bit.

At training row counts a bf16 lhs-gated call, gated or compacted, takes
the *tall path* (:func:`tall_path`, a function of the shapes, blocks,
dtype and gate only): ``csrc/tall_gemm.cuh``'s kernel, wgmma fed by TMA
over 128-row tiles, with the column tile and the chunks of
:func:`tall_plan` (one chunk but for a WG's long reduction). Both
wrappers then launch the same kernel with the same plan, so they stay
equal bit for bit there too. Decode, f32, the rhs and two-sided gates
keep the core above.
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


# Chunks of k tiles the gated and compacted kernels split K into, at most.
MAX_CHUNKS = 8


def chunk_tiles(k: int, block_k: int) -> int:
    """k tiles per chunk: chunk c sums the k tiles [c*S, (c+1)*S). A
    function of (K, block_k) only -- never of the bits, M or a kernel's
    block -- so both kernels split every row's sum at the same tiles."""
    gk = _ceil_div(k, block_k)
    return max(1, _ceil_div(gk, max(1, min(gk, MAX_CHUNKS))))


def num_chunks(k: int, block_k: int) -> int:
    """Chunks (the grid's third dimension) at ``chunk_tiles(k, block_k)``."""
    return max(1, _ceil_div(_ceil_div(k, block_k), chunk_tiles(k, block_k)))


def partial_shape(m: int, k: int, n: int, block_k: int) -> tuple:
    """The f32 scratch the kernels write the chunks' partial sums to:
    (chunks, M, N), or (0,) with one chunk (the kernel then writes y
    itself)."""
    nc = num_chunks(k, block_k)
    return (nc, m, n) if nc > 1 else (0,)


# ------------------------------------------------------------ tall path
# The tall kernel's geometry (csrc/tall_gemm.cuh): 128-row tiles of two
# 64-row warpgroups, 64-deep stages, column tiles of 128 or 192.
TALL_MIN_ROWS = 512
TALL_BM = 128
TALL_STAGE_K = 64
TALL_BN = (128, 192)
TALL_MAX_CHUNKS = 8
# K a chunk at least: K splits only from 2048 (a WG over 4096 tokens
# runs 4 chunks; the FP's 1536 and BP's 576 run one).
TALL_CHUNK_K = 1024


def tall_path(m: int, k: int, n: int, *, block_m: int, block_k: int,
              dtype: torch.dtype, gate: str = "lhs") -> bool:
    """Whether a gated (or compacted) call takes the tall path: bf16 under
    the lhs gate, at least ``TALL_MIN_ROWS`` rows (many 64-row slabs: a
    pipeline micro-batch's 1024 and a tp-3 shard's WG over 512 rows
    count, a 256-row prefill does not), row tiles whole 64-row
    warpgroups, k tiles whole 64-deep stages, and K and N multiples of 8
    (rows of whole 16-byte units, as TMA reads them). A function of the
    shapes, blocks, dtype and gate only; ``csrc/tall_gemm.cuh:gemm_ok``
    is its C side."""
    return (dtype == torch.bfloat16 and gate == "lhs"
            and m >= TALL_MIN_ROWS and k > 0 and n > 0
            and block_m % 64 == 0 and block_k % TALL_STAGE_K == 0
            and k % 8 == 0 and n % 8 == 0)


def tall_plan(m: int, k: int, n: int, *, block_m: int, block_k: int,
              dtype: torch.dtype, gate: str = "lhs"):
    """The tall path's (column tile, k tiles a chunk) at these shapes, or
    None off the path. A function of (K, N, block_k) only -- never of M
    or the bits -- so a row's sum runs in the same order whatever the
    call's row count (a pipeline micro-batch's rows equal the whole
    batch's bit for bit, as the core's chunks of ``chunk_tiles(K,
    block_k)`` keep them) and a gated and a compacted call at one shape
    sum every output alike. The column tile is 192 where it divides N
    (576 and 1536: 3 and 8 tiles, no ragged one), else 128; K splits into
    K // ``TALL_CHUNK_K`` chunks (at most ``TALL_MAX_CHUNKS``), so only a
    WG's reduction over a step's tokens splits, whose output tiles alone
    leave most of the card idle."""
    if not tall_path(m, k, n, block_m=block_m, block_k=block_k,
                     dtype=dtype, gate=gate):
        return None
    gk = _ceil_div(k, block_k)
    chunks = max(1, min(TALL_MAX_CHUNKS, gk, k // TALL_CHUNK_K))
    return (192 if n % 192 == 0 else 128), _ceil_div(gk, chunks)


def tall_partial_shape(m: int, k: int, n: int, *, block_k: int,
                       chunk: int) -> tuple:
    """The tall path's f32 scratch at ``chunk`` k tiles a chunk:
    (chunks, M, N), or (0,) with one chunk (the kernel writes y)."""
    chunks = _ceil_div(_ceil_div(k, block_k), chunk)
    return (chunks, m, n) if chunks > 1 else (0,)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it on a 16-byte boundary (TMA's need; a view into
    a larger tensor may start off one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_tall(x, w, bits, out_dtype, block_m, block_k, plan):
    """Allocate y and the scratch and call ``sparce_gemm_tall``; returns
    (y, cudaError)."""
    _, (bits,) = _launch_checks("sparce_gemm_tall", x, w, out_dtype,
                                bits=bits)
    x, w = _aligned(x), _aligned(w)
    m, k = x.shape
    n = w.shape[1]
    bn, s = plan
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    shape = tall_partial_shape(m, k, n, block_k=block_k, chunk=s)
    partial = (torch.empty(shape, dtype=torch.float32, device=x.device)
               if len(shape) == 3 else None)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_gemm", "sparce_gemm_tall",
                         [p] * 5 + [i] * 7 + [p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), bits.data_ptr(), y.data_ptr(),
             None if partial is None else partial.data_ptr(), m, k, n,
             block_m, block_k, bn, s, stream)
    return y, err


def tall_ok_c(m: int, k: int, n: int, *, block_m: int, block_k: int) -> bool:
    """The C side of :func:`tall_path` for a bf16 lhs-gated call (builds
    the library)."""
    i = ctypes.c_int
    fn = _build.function("sparce_gemm", "sparce_gemm_tall_ok", [i] * 5)
    return bool(fn(m, k, n, block_m, block_k))


def _launch_gemm(name, x, w, bits, out_dtype, block_k, *args, rbits=None):
    """Allocate y and the f32 scratch and call the C launch function
    ``name(x, w, bits[, rbits], y, scratch, M, K, N, *args, S, dtype,
    stream)`` (``rbits``: the two-sided kernel's second grid). Returns
    (y, cudaError)."""
    grids = dict(bits=bits) if rbits is None else dict(lbits=bits,
                                                       rbits=rbits)
    dtype_id, grids = _launch_checks(name, x, w, out_dtype, **grids)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = torch.empty(partial_shape(m, k, n, block_k),
                          dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sparce_gemm", name,
                         [p] * (4 + len(grids)) + [i] * (3 + len(args) + 2)
                         + [p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), *(b.data_ptr() for b in grids),
             y.data_ptr(), partial.data_ptr() if partial.numel() else None,
             m, k, n, *args, chunk_tiles(k, block_k), dtype_id, stream)
    return y, err


def _live_cols(live_k: torch.Tensor, block_k: int, k: int) -> torch.Tensor:
    """The k indices of the live k tiles ``live_k`` (ascending)."""
    ar = torch.arange(block_k, device=live_k.device)
    idx = (live_k[:, None] * block_k + ar).flatten()
    return idx[idx < k]


def _launch_checks(name, x, w, out_dtype, **bits):
    """Device, dtype and contiguity checks of a GEMM kernel's operands;
    returns the dtype id and the bit grids made contiguous."""
    dtype_id = _build.check_operands(name, x=x, w=w)
    if out_dtype not in (None, x.dtype):
        raise TypeError("the kernel writes y in x's dtype")
    for key, b in bits.items():
        if b.device != x.device or b.dtype != torch.int32:
            raise TypeError(f"{key} must be int32 on {x.device}")
    return dtype_id, [b.contiguous() for b in bits.values()]


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
    live = (bits == 0).cpu()
    if gate == "lhs":
        for i in range(bits.shape[0]):
            ks = _live_cols(live[i].nonzero().flatten().to(x.device),
                            block_k, k)
            if ks.numel():
                rows = slice(i * block_m, (i + 1) * block_m)
                y[rows] = (x[rows].index_select(1, ks).float()
                           @ w.index_select(0, ks).float())
    else:
        for j in range(bits.shape[1]):
            ks = _live_cols(live[:, j].nonzero().flatten().to(x.device),
                            block_k, k)
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
    plan = tall_plan(x.shape[0], x.shape[1], w.shape[1], block_m=block_m,
                     block_k=block_k, dtype=x.dtype, gate=gate)
    if plan is not None:
        y, err = _launch_tall(x, w, bits, out_dtype, block_m, block_k, plan)
        sparce_gemm_gated.tall_launches += 1
    else:
        y, err = _launch_gemm("sparce_gemm_gated", x, w, bits, out_dtype,
                              block_k, block_m, block_k, block_n,
                              int(gate == "rhs"))
    sparce_gemm_gated.launches += 1
    if err != 0:
        raise RuntimeError(f"sparce_gemm_gated launch failed: cudaError {err}")
    return y


sparce_gemm_gated.launches = 0
sparce_gemm_gated.tall_launches = 0  # of them, on the tall path


# ------------------------------------------------------------- compacted


def sparce_gemm_compacted_plain(
    x: torch.Tensor, w: torch.Tensor, bits: torch.Tensor, *, block_m: int,
    block_k: int, block_n: int, out_dtype=None,
) -> torch.Tensor:
    """What the compacted kernel computes, in plain PyTorch: per row
    tile, the product over its nonzero k tiles only (the compacted list,
    ascending), in f32, cast once; exact zeros for a row tile with none.
    It is the lhs-gated product, so it is :func:`sparce_gemm_gated_plain`
    with ``gate="lhs"``: no dead x tile, and no w k-stripe that no live
    row tile lists, is ever indexed."""
    return sparce_gemm_gated_plain(
        x, w, bits, block_m=block_m, block_k=block_k, block_n=block_n,
        gate="lhs", out_dtype=out_dtype)


def sparce_gemm_compacted(
    x: torch.Tensor, w: torch.Tensor, bits: torch.Tensor, *, block_m: int,
    block_k: int, block_n: int, out_dtype=None,
) -> torch.Tensor:
    """Compacted-grid GEMM: y = x @ w where each (block_m)-row tile walks
    only the k tiles whose bit is 0 (bits int32 (ceil(M/block_m),
    ceil(K/block_k)), 1 == zero tile), so a dead tile is neither computed
    nor loaded. The list is built on the device, inside the kernel, one
    k chunk at a time, so its length has no cap.
    ``block_n`` is the plan's column tile; the result does not depend on
    it. CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return sparce_gemm_compacted_plain(
            x, w, bits, block_m=block_m, block_k=block_k, block_n=block_n,
            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(
            f"sparce_gemm_compacted: unsupported device {x.device}")
    _check(x, w, bits, block_m, block_k, block_n, "lhs")
    plan = tall_plan(x.shape[0], x.shape[1], w.shape[1], block_m=block_m,
                     block_k=block_k, dtype=x.dtype)
    if plan is not None:
        y, err = _launch_tall(x, w, bits, out_dtype, block_m, block_k, plan)
        sparce_gemm_compacted.tall_launches += 1
    else:
        y, err = _launch_gemm("sparce_gemm_compacted", x, w, bits,
                              out_dtype, block_k, block_m, block_k)
    sparce_gemm_compacted.launches += 1
    if err != 0:
        raise RuntimeError(
            f"sparce_gemm_compacted launch failed: cudaError {err}")
    return y


sparce_gemm_compacted.launches = 0
sparce_gemm_compacted.tall_launches = 0  # of them, on the tall path


# ------------------------------------------------------ two-sided gate
def _check_both(x, w, lbits, rbits, block_m, block_k, block_n):
    _check(x, w, lbits, block_m, block_k, block_n, "lhs")
    grid = bit_grid(x.shape[0], x.shape[1], w.shape[1], block_m=block_m,
                    block_k=block_k, block_n=block_n, gate="rhs")
    if tuple(rbits.shape) != grid:
        raise ValueError(f"rhs bits must be {grid}, got "
                         f"{tuple(rbits.shape)}")


def sparce_gemm_gated_both_plain(
    x: torch.Tensor, w: torch.Tensor, lbits: torch.Tensor,
    rbits: torch.Tensor, *, block_m: int, block_k: int, block_n: int,
    out_dtype=None,
) -> torch.Tensor:
    """What the two-sided kernel computes, in plain PyTorch: per output
    tile (i, j), the product over the k tiles with ``lbits[i, k] == 0``
    and ``rbits[k, j] == 0`` only, in f32, cast once. A tile product
    that either bit drops indexes neither of its tiles."""
    _check_both(x, w, lbits, rbits, block_m, block_k, block_n)
    m, k = x.shape
    n = w.shape[1]
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    live = ((lbits == 0)[:, :, None] & (rbits == 0)[None, :, :]).cpu()
    for i in range(lbits.shape[0]):
        rows = slice(i * block_m, (i + 1) * block_m)
        for j in range(rbits.shape[1]):
            ks = _live_cols(live[i, :, j].nonzero().flatten().to(x.device),
                            block_k, k)
            if ks.numel():
                cs = slice(j * block_n, (j + 1) * block_n)
                y[rows, cs] = (x[rows].index_select(1, ks).float()
                               @ w[:, cs].index_select(0, ks).float())
    return y.to(out_dtype or x.dtype)


def sparce_gemm_gated_both(
    x: torch.Tensor, w: torch.Tensor, lbits: torch.Tensor,
    rbits: torch.Tensor, *, block_m: int, block_k: int, block_n: int,
    out_dtype=None,
) -> torch.Tensor:
    """y = x @ w with a tile product dropped when either operand's bit
    is 1 (the paper's SpRFCondition ``Ra | Rb``): lbits int32 over x's
    (block_m, block_k) tiles, rbits int32 over w's (block_k, block_n)
    tiles, see :func:`bit_grid`. Both bits are read before either tile
    is loaded. CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return sparce_gemm_gated_both_plain(
            x, w, lbits, rbits, block_m=block_m, block_k=block_k,
            block_n=block_n, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(
            f"sparce_gemm_gated_both: unsupported device {x.device}")
    _check_both(x, w, lbits, rbits, block_m, block_k, block_n)
    y, err = _launch_gemm("sparce_gemm_gated_both", x, w, lbits, out_dtype,
                          block_k, block_m, block_k, block_n, rbits=rbits)
    sparce_gemm_gated_both.launches += 1
    if err != 0:
        raise RuntimeError(
            f"sparce_gemm_gated_both launch failed: cudaError {err}")
    return y


sparce_gemm_gated_both.launches = 0
