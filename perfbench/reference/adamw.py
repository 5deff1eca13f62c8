"""Plain AdamW in float32: the update the training configuration states.

Gradients clipped to a global norm of ``clip_norm`` (scale
``min(1, clip / (norm + 1e-9))``), moments ``m = b1 m + (1 - b1) g`` and
``v = b2 v + (1 - b2) g^2``, bias-corrected, weight decay on matrices
only, at a constant learning rate. Parameters stay in f32.
"""
from __future__ import annotations

from typing import Dict, List

import torch


class AdamW:
    def __init__(self, leaves: List[torch.Tensor], hp: Dict[str, float]):
        self.p = leaves
        self.hp = hp
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.n = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One update; returns the clipped gradients it applied."""
        hp = self.hp
        self.n += 1
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp_max(hp["clip_norm"] / (norm + 1e-9), 1.0)
        grads = [g * scale for g in grads]
        b1, b2 = hp["b1"], hp["b2"]
        bc1, bc2 = 1 - b1 ** self.n, 1 - b2 ** self.n
        for p, m, v, g in zip(self.p, self.m, self.v, grads):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + hp["eps"])
            if p.ndim >= 2:
                delta = delta + hp["weight_decay"] * p
            p.sub_(hp["lr"] * delta)
        return grads
