"""Sparsity Register File (SpRF) analogue: per-tile zero bitmaps.

Port of the reference ``repro/core/sprf.py``. One bit per
(block_rows x block_cols) tile of a sparse operand, bit == 1 meaning the
tile is entirely zero (the paper's ``isSparse`` semantics), stored as an
int32 tensor in the reference's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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
