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

On a mesh (``update(..., shard=...)``) every rank holds its slices of
the params and grads (``parallel/sharding.py:param_specs``) and of the
moments (:func:`opt_state_shardings`, the reference's ZeRO-1 rule); the
global norm sums the squares of each leaf once over the mesh, and a
ZeRO-1 rank updates its slice of each moment and the matching slice of
the param, then all-gathers the updated param slices over 'data'.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.modules import iter_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # int32, 0-d, on the host (see host_step)
    mu: Any  # first moment (f32), the params' tree
    nu: Any  # second moment (f32)


def host_step(step: int = 0) -> torch.Tensor:
    """The step counter: an int32 0-d tensor on the host, whatever device
    the params are on. The update reads it on the host for the schedule
    and the bias corrections, so a step on the card waits for no device
    work to read it, and a step traced on the meta device (the dry run)
    can read it at all."""
    return torch.tensor(step, dtype=torch.int32)


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


def global_norm(tree, shard: Optional["Shard"] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. With ``shard``
    the leaves are this rank's slices: a leaf cut over 'model' has its
    squares summed over 'model', a leaf whole on every rank of 'model'
    is counted once."""
    if shard is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in iter_leaves(tree)))
    from repro_torch.parallel import collectives  # noqa: PLC0415
    from repro_torch.parallel.sharding import spec_axes  # noqa: PLC0415

    dev = next(iter(iter_leaves(tree))).device
    cut = torch.zeros((), dtype=torch.float32, device=dev)
    whole = torch.zeros((), dtype=torch.float32, device=dev)
    for x, spec in zip(iter_leaves(tree), shard.param_specs):
        sq = torch.sum(torch.square(x.float()))
        if "model" in spec_axes(spec):
            cut = cut + sq
        else:
            whole = whole + sq
    if "model" in shard.mesh.shape:
        cut = collectives.psum(cut.reshape(1), "model", shard.mesh)[0]
    return torch.sqrt(cut + whole)


def opt_state_shardings(state: "AdamState", param_specs, mesh, *,
                        zero1: bool = False) -> "AdamState":
    """Specs of the optimizer state (the reference's rule): each moment
    takes its param's spec; under ZeRO-1 its largest still-replicated
    dim that divides by the data size (and is > 1) is cut over 'data'
    too. The step counter is replicated. ``state`` holds the full-size
    moments (only their shapes are read)."""
    from repro_torch.parallel.sharding import (  # noqa: PLC0415
        iter_leaves_specs,
    )

    def one(spec, leaf):
        ndim = len(leaf.shape)
        spec = list(spec) + [None] * (ndim - len(spec))
        data = mesh.shape.get("data", 0)
        if zero1 and data:
            cand = [(leaf.shape[i], i) for i in range(ndim)
                    if spec[i] is None and leaf.shape[i] % data == 0
                    and leaf.shape[i] > 1]
            if cand:
                spec[max(cand)[1]] = "data"
        return tuple(spec)

    specs = list(iter_leaves_specs(param_specs))
    it = iter(specs)
    mu = tree_map(lambda leaf: one(next(it), leaf), state.mu)
    it = iter(specs)
    nu = tree_map(lambda leaf: one(next(it), leaf), state.nu)
    return AdamState(step=(), mu=mu, nu=nu)


@dataclasses.dataclass
class Shard:
    """One rank's place in a sharded update: the mesh, the params'
    specs and the moments' specs, each a list in ``iter_leaves`` order."""

    mesh: Any
    param_specs: list
    moment_specs: list


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
        return AdamState(step=host_step(), mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params,
               shard: Optional[Shard] = None
               ) -> Tuple[Any, AdamState, dict]:
        """One step; returns fresh params and state (the inputs are not
        modified) and ``{"grad_norm", "lr"}``. With ``shard`` the trees
        hold this rank's slices (see :class:`Shard`)."""
        n = int(state.step) + 1
        step = host_step(n)
        gnorm = global_norm(grads, shard)
        if self.clip_norm is not None:
            scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
            grads = tree_map(lambda g: g.float() * scale, grads)
        else:
            grads = tree_map(lambda g: g.float(), grads)
        if shard is not None:
            grads = _slices(grads, shard)
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

        if shard is None:
            new_params = tree_map(upd, params, mu, nu)
        else:
            new_params = self._zero1_params(upd, params, mu, nu, shard)
        return new_params, AdamState(step, mu, nu), {
            "grad_norm": gnorm,
            "lr": torch.tensor(lr, dtype=torch.float32)}

    def _zero1_params(self, upd, params, mu, nu, shard: Shard):
        """``upd`` on each param's slice that matches its moment's (the
        whole param where the moment is not cut over 'data'), the updated
        slices all-gathered over 'data': one all-gather per dtype, of
        the rank's slices laid end to end."""
        from repro_torch.parallel import collectives  # noqa: PLC0415

        dims = _data_dims(shard)
        i = shard.mesh.coord("data") if "data" in shard.mesh.shape else 0
        leaves = list(zip(iter_leaves(params), iter_leaves(mu),
                          iter_leaves(nu), dims))
        out = [None] * len(leaves)
        cut = {}
        for k, (p, m, v, dim) in enumerate(leaves):
            if dim is None:
                out[k] = upd(p, m, v)
                continue
            size = m.shape[dim]
            new = upd(p.narrow(dim, i * size, size), m, v)
            cut.setdefault(new.dtype, []).append((k, new))
        for dtype in sorted(cut, key=str):
            parts = collectives.all_gather(
                torch.cat([t.reshape(-1) for _, t in cut[dtype]])[None],
                "data", shard.mesh)  # (n, total)
            off = 0
            for k, t in cut[dtype]:
                n = t.numel()
                out[k] = torch.cat([r[off:off + n].view(t.shape)
                                    for r in parts], dim=dims[k])
                off += n
        it = iter(out)
        return tree_map(lambda _: next(it), params)


def _data_dims(shard: Shard) -> list:
    """Per leaf, the dim a ZeRO-1 moment cuts over 'data' beyond its
    param (None: the moment is the param's slice)."""
    out = []
    for ps, ms in zip(shard.param_specs, shard.moment_specs):
        ps = list(ps) + [None] * (len(ms) - len(ps))
        out.append(next((i for i, (a, b) in enumerate(zip(ps, ms))
                         if a != b), None))
    return out


def _slices(grads, shard: Shard):
    """Each grad cut to its moment's slice (ZeRO-1)."""
    dims = iter(_data_dims(shard))

    def one(g):
        dim = next(dims)
        if dim is None:
            return g
        n = shard.mesh.shape["data"]
        size = g.shape[dim] // n
        return g.narrow(dim, shard.mesh.coord("data") * size, size)

    return tree_map(one, grads)
