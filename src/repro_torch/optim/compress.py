"""Error-feedback gradient compression for the cross-pod all-reduce.

Port of ``repro/optim/compress.py``: 1-bit (sign) and int8 compression
with error feedback (the quantization error is added back to the next
step's gradient; Seide et al., 1-bit SGD, the paper's [38]). Each rank
quantizes its gradient, all-gathers the quantized payload over the axis
and dequantizes locally, so the wire carries the compressed form:

    bytes on the wire:  f32 4B -> int8 1B (4x) -> sign 1 bit (32x)

The payload of one leaf is one all-gather of the rank's int8 ``q`` with
its f32 scale appended (``q.numel() + 4`` operand bytes in the
collectives' counters). As in the reference, nothing in the training
step calls it.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.modules import iter_leaves, tree_map


def _quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_sign(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.mean(torch.abs(g)) + 1e-12
    return torch.sign(g).to(torch.int8), scale


_QUANTIZERS = {"int8": _quantize_int8, "1bit": _quantize_sign}


def init_residuals(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads: Any, residuals: Any, axis, *,
                    method: str = "int8", mesh=None) -> Tuple[Any, Any]:
    """The mean of ``grads`` over the ranks of ``axis`` with error
    feedback, on every rank of a mesh (``mesh``: default the process's).
    Returns (averaged grads, new residuals), f32."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    quant = _QUANTIZERS[method]

    def one(g, r):
        g = g.float() + r
        q, scale = quant(g)
        new_r = g - q.float() * scale  # error feedback
        wire = torch.cat([q.reshape(-1).view(torch.uint8),
                          scale.reshape(1).view(torch.uint8)])
        parts = collectives.all_gather(wire[None], axis, mesh)
        n = parts.shape[0]
        qs = parts[:, :-4].contiguous().view(torch.int8).float()
        ss = parts[:, -4:].contiguous().view(torch.float32)  # (n, 1)
        summed = (qs * ss).sum(dim=0).reshape(g.shape)
        return summed / n, new_r

    out = [one(g, r) for g, r in zip(iter_leaves(grads),
                                     iter_leaves(residuals))]
    avg, res = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(avg), grads),
            tree_map(lambda _: next(res), grads))


def wire_bytes(params: Any, method: str) -> Tuple[int, int]:
    """(uncompressed, compressed) bytes per all-reduce round."""
    n = sum(p.numel() for p in iter_leaves(params))
    return n * 4, (n if method == "int8" else n // 8)
