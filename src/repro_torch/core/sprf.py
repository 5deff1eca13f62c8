"""Sparsity Register File (SpRF) analogue: per-tile zero bitmaps.

Port of the reference ``repro/core/sprf.py``. One bit per
(block_rows x block_cols) tile of a sparse operand, bit == 1 meaning the
tile is entirely zero (the paper's ``isSparse`` semantics), stored as an
int32 tensor in the reference's layout. Also the operands of the paper's
evaluation: magnitude-pruned weights (:func:`prune_weights`) and random
matrices with an exact zero count (:func:`random_sparse`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TileBitmap:
    """Per-tile sparsity metadata for a 2-D operand.

    bits: int32[num_tiles_rows, num_tiles_cols]; 1 == tile all-zero.
    block: (block_rows, block_cols) tile shape the bits refer to.
    shape: logical (rows, cols) of the operand (pre-padding).
    """

    bits: torch.Tensor
    block: Tuple[int, int]
    shape: Tuple[int, int]

    @property
    def grid(self) -> Tuple[int, int]:
        return tuple(self.bits.shape)

    def sparsity(self) -> torch.Tensor:
        """Fraction of tiles that are skippable (block-level sparsity)."""
        return self.bits.float().mean()

    def num_skipped(self) -> torch.Tensor:
        return self.bits.sum()

    def transpose(self) -> "TileBitmap":
        return TileBitmap(bits=self.bits.T, block=(self.block[1],
                                                   self.block[0]),
                          shape=(self.shape[1], self.shape[0]))

    def logical_or(self, other: "TileBitmap") -> "TileBitmap":
        """SpRFCondition ``Ra | Rb``: skip when either operand tile is
        zero."""
        if self.bits.shape != other.bits.shape or self.block != other.block:
            raise ValueError(
                f"bitmaps differ: {tuple(self.bits.shape)} {self.block} vs "
                f"{tuple(other.bits.shape)} {other.block}")
        return TileBitmap(bits=torch.maximum(self.bits, other.bits),
                          block=self.block, shape=self.shape)


def compute_bitmap(x: torch.Tensor, block: Tuple[int, int]) -> TileBitmap:
    """A tile is skippable iff every element in it is exactly zero.
    Ragged operands are treated as zero-padded."""
    if x.ndim != 2:
        raise ValueError(
            f"bitmaps are 2-D tile metadata, got shape {tuple(x.shape)}")
    rows, cols = x.shape
    br, bc = block
    pr, pc = _ceil_div(rows, br) * br, _ceil_div(cols, bc) * bc
    if (pr, pc) != (rows, cols):
        x = F.pad(x, (0, pc - cols, 0, pr - rows))
    t = x.reshape(pr // br, br, pc // bc, bc)
    any_nonzero = (t != 0).any(dim=3).any(dim=1)
    return TileBitmap(
        bits=(~any_nonzero).to(torch.int32), block=(br, bc),
        shape=(rows, cols),
    )


def weight_bitmap(w: torch.Tensor, block: Tuple[int, int]) -> TileBitmap:
    """Static-sparsity bitmap for (pruned) weights; computed once at load."""
    return compute_bitmap(w, block)


def prune_weights(w: torch.Tensor, sparsity: float,
                  block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Magnitude-prune ``w`` to ``sparsity`` fraction of zeros, as the
    reference does: unstructured, every word with ``|w| <=`` the k-th
    smallest magnitude is zeroed (ties at the threshold go too); with
    ``block``, whole blocks by block-L2 magnitude (f32), keeping only
    blocks strictly above the k-th smallest norm."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    if sparsity == 0.0:
        return w
    if block is None:
        k = int(round(sparsity * w.numel()))
        if k == 0:
            return w
        thresh = torch.sort(w.abs().reshape(-1)).values[k - 1]
        return torch.where(w.abs() <= thresh, torch.zeros_like(w), w)
    rows, cols = w.shape
    br, bc = block
    pr, pc = _ceil_div(rows, br) * br, _ceil_div(cols, bc) * bc
    wp = F.pad(w, (0, pc - cols, 0, pr - rows))
    t = wp.reshape(pr // br, br, pc // bc, bc)
    mag = t.float().pow(2).sum(dim=(1, 3)).sqrt()
    k = int(round(sparsity * mag.numel()))
    if k == 0:
        return w
    thresh = torch.sort(mag.reshape(-1)).values[k - 1]
    keep = (mag > thresh)[:, None, :, None]
    wp = torch.where(keep, t, torch.zeros_like(t)).reshape(pr, pc)
    # Dense, as the reference's sliced array is: a strided view of the
    # padded grid would be copied by the GEMM wrappers on every call.
    return wp[:rows, :cols].contiguous()


def random_sparse(generator: torch.Generator, shape: Tuple[int, int],
                  sparsity: float, dtype=torch.float32, *,
                  cluster: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Random normal matrix with exactly ``round(sparsity * n)`` zeroed
    words (``cluster=None``: the paper's Fig. 17 setup, zeros at random
    places) or zeroed (r, c) clusters out of the ceil-divided cluster
    grid (block-clustered sparsity, as in pruned weights; clusters are
    cut at the ragged edge).

    Drawn from ``generator`` (values, then the zero positions) on the
    generator's device; the numbers are not the reference's, which draws
    with its own framework's keys, but the counts and the geometry are."""
    gdev = generator.device
    vals = torch.randn(shape, generator=generator, device=gdev,
                       dtype=torch.float32)
    if cluster is None:
        n = shape[0] * shape[1]
        nz = int(round(sparsity * n))
        perm = torch.randperm(n, generator=generator, device=gdev)
        mask = torch.ones(n, device=gdev)
        mask[perm[:nz]] = 0.0
        mask = mask.reshape(shape)
    else:
        cr, cc = cluster
        gr, gc = _ceil_div(shape[0], cr), _ceil_div(shape[1], cc)
        n = gr * gc
        nz = int(round(sparsity * n))
        perm = torch.randperm(n, generator=generator, device=gdev)
        gmask = torch.ones(n, device=gdev)
        gmask[perm[:nz]] = 0.0
        mask = gmask.reshape(gr, gc).repeat_interleave(cr, 0)
        mask = mask.repeat_interleave(cc, 1)[: shape[0], : shape[1]]
    return (vals * mask).to(dtype)
