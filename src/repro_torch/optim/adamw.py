"""AdamW with a cosine schedule and global-norm clipping.

Port of ``repro/optim/adamw.py``, functional like it:

    opt = AdamW(lr=...)
    state = opt.init(params)
    params, state, stats = opt.update(grads, state, params)

Params and grads are the port's nested dict / list trees of tensors.
The moments are f32; the update is computed in f32 and cast back to each
param's dtype (round to nearest even, as the reference's cast does);
weight decay applies to matrices only. The schedule and the bias
corrections are f32 scalars computed on the host from the step count.
ZeRO-1 moment sharding (the reference's ``opt_state_shardings``) waits
for the multi-device port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.modules import iter_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    mu: Any  # first moment (f32), the params' tree
    nu: Any  # second moment (f32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], np.float32]:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``floor * peak_lr`` at ``total``; f32 arithmetic, as the reference."""
    f32 = np.float32

    def lr(step) -> np.float32:
        s = f32(step)
        if s < warmup:
            return f32(peak_lr) * min(f32(1.0), s / f32(max(1, warmup)))
        frac = np.clip((s - f32(warmup)) / f32(max(1, total - warmup)),
                       f32(0.0), f32(1.0))
        return f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5) * (
            f32(1) + np.cos(f32(math.pi) * frac)))
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in iter_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable[[int], float]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        some = next(iter(iter_leaves(params)))
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=some.device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params
               ) -> Tuple[Any, AdamState, dict]:
        """One step; returns fresh params and state (the inputs are not
        modified) and ``{"grad_norm", "lr"}``."""
        step = state.step + 1
        n = int(step)
        gnorm = global_norm(grads)
        if self.clip_norm is not None:
            scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
            grads = tree_map(lambda g: g.float() * scale, grads)
        else:
            grads = tree_map(lambda g: g.float(), grads)
        f32 = np.float32
        lr = f32(self.lr(n) if callable(self.lr) else self.lr)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        bc1 = float(f32(1) - f32(b1) ** f32(n))
        bc2 = float(f32(1) - f32(b2) ** f32(n))

        def upd(p, m, v):
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay and p.ndim >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p.float()
            return (p.float() - float(lr) * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamState(step, mu, nu), {
            "grad_norm": gnorm,
            "lr": torch.tensor(lr, dtype=torch.float32)}
