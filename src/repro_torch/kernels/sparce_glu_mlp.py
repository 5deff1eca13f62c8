"""Gated-GLU SparCE MLP: predict-then-skip for silu/gelu MLPs.

Port of the TPU kernel ``repro/kernels/sparce_glu_mlp.py:
sparce_glu_mlp_fused``: ``y = (act(x @ w_gate) * (x @ w_in)) @ w_out``
with the gate computed first per (row tile, f-stripe) and the SpRF bit
emitted at its writeback, ``bit = all(|act(g)| <= tau)``. A dead tile
skips BOTH weight stripes -- its ``w_in`` columns and its ``w_out`` rows
are never loaded (two-sided skip-before-fetch).

The CUDA kernel (``csrc/sparce_glu_mlp.cu``) runs in two passes because
GPU thread blocks cannot carry the TPU kernel's accumulator across a
sequential grid: per-tile partial down-projections into f32 scratch,
then a fixed-order reduction over the live stripes.

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
# Shared memory the CUDA kernel stages besides the (bm, bf) f32 tile.
_STAGE_FLOATS = 64 * 33 + 32 * 128
_SMEM_LIMIT = 227 * 1024


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round an f32 tensor through ``dtype`` and back to f32."""
    return t.to(dtype).float()


def _check(x, w_gate, w_in, w_out, block_m, block_f, act, tau):
    if act not in _GLU_ACTS:
        raise ValueError(f"act must be one of {_GLU_ACTS}, got {act!r}")
    if tau < 0.0:
        raise ValueError(f"gate threshold must be >= 0, got {tau}")
    m, k = x.shape
    kg, fg = w_gate.shape
    k2, fdim = w_in.shape
    f2, _ = w_out.shape
    if not (k == kg == k2 and fdim == fg == f2):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_in {tuple(w_in.shape)}, w_out "
            f"{tuple(w_out.shape)}")
    if m % block_m or fdim % block_f:
        raise ValueError(
            f"padded dims required: M={m} % {block_m}, F={fdim} % {block_f}")


# ----------------------------------------------------------- plain version
def sparce_glu_mlp_fused_plain(
    x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
    w_out: torch.Tensor, *, block_m: int, block_f: int, act: str = "silu",
    tau: float = 0.0, out_dtype=None,
):
    """What the kernel computes, in plain PyTorch: the gate over every
    stripe (it is the predictor), then per row tile only the LIVE
    stripes' columns of ``w_in`` and rows of ``w_out`` are read. Returns
    (y, bits)."""
    _check(x, w_gate, w_in, w_out, block_m, block_f, act, tau)
    m, _ = x.shape
    fdim = w_in.shape[1]
    n = w_out.shape[1]
    dt = x.dtype
    nm, nf = m // block_m, fdim // block_f
    xf = x.float()
    g = _round(xf @ w_gate.float(), dt)
    ga = _round(act_f32(g, act), dt)
    dead = (ga.abs() <= tau).reshape(nm, block_m, nf, block_f)
    bits = dead.all(dim=3).all(dim=1).to(torch.int32)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for i in range(nm):
        live = (bits[i] == 0).nonzero().flatten()
        if live.numel() == 0:
            continue
        cols = (live[:, None] * block_f
                + torch.arange(block_f, device=x.device)).flatten()
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

    x: (M, K); w_gate, w_in: (K, F); w_out: (F, N); M % block_m == 0 and
    F % block_f == 0 (``ops.sparce_glu_mlp_fused`` pads). Returns
    (y (M, N), bits int32 (M/block_m, F/block_f)), 1 == dead tile.
    CUDA tensors launch the kernel, CPU tensors run the plain version.
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
    smem = 4 * (block_m * block_f + _STAGE_FLOATS)
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
    fn = _build.function("sparce_glu_mlp", "sparce_glu_mlp",
                         [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                          ctypes.c_float, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), w_gate.data_ptr(), w_in.data_ptr(), w_out.data_ptr(),
        y.data_ptr(), bits.data_ptr(), partial.data_ptr(),
        m, k, fdim, n, block_m, block_f, _ACT_IDS[act], float(tau),
        dtype_id, stream)
    sparce_glu_mlp_fused.launches += 1
    if err != 0:
        raise RuntimeError(f"sparce_glu_mlp_fused launch failed: cudaError {err}")
    return y, bits


sparce_glu_mlp_fused.launches = 0
