"""GPipe-style pipeline parallelism over the ``pod`` mesh axis.

Port of ``repro/parallel/pipeline.py``. Pods become stages: the
cross-pod traffic is one micro-batch of activations a step through
:func:`collectives.ppermute` instead of an all-reduce of the params.

Every rank runs the reference's ``shard_map`` body as manual SPMD: its
stage is its coordinate on the pipeline axis, it reads only that
stage's slice of the stacked params, and the micro-batches flow through
a ppermute ring under the canonical (n_micro + n_stages - 1)-step
schedule. Ranks on the other axes compute the same. The function is
differentiable with respect to the params and ``x``: each rank builds
the same graph (the reference's ``jnp.where`` selections, not Python
branches on the stage), so the backward's inverse ring exchanges meet
in the same order on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.models.modules import tree_map
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import Mesh, Spec, shard_of


def ring(n_stages: int):
    """The hand-off of one schedule step: stage s to s + 1 (the last
    stage's send wraps to stage 0, which ignores it)."""
    return [(i, (i + 1) % n_stages) for i in range(n_stages)]


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    mesh: Optional[Mesh],
    *,
    axis: str = "pod",
    n_micro: Optional[int] = None,
    extra_specs: Optional[Spec] = None,
) -> torch.Tensor:
    """Run ``x`` through n_stages pipeline stages on this rank.

    stage_params: a tree whose leaves have a leading stage axis (==
    ``mesh.shape[axis]``); this rank reads its stage's slice only.
    x: (batch, ...), whole on every rank, split into ``n_micro``
    micro-batches on the batch dim. stage_fn(params_for_stage, micro) ->
    micro (same shape). ``extra_specs``: the spec of the stacked
    micro-batches (n_micro, mb, ...) over the other axes, default
    replicated; each rank then runs and returns its block of them.
    Returns y with x's shape (the rank's block's, under ``extra_specs``).

    Every rank holds the same y, gathered from the last stage; its
    gradient is this rank's slice of the cotangent (``gather_on_use``'s
    rule), not the sum of the ranks'. That is the reference's gradient
    when every rank along ``axis`` uses y the same way (as a replicated
    output of its ``shard_map`` is one value); a caller whose ranks use
    y differently gets wrong stage gradients.
    """
    mesh = mesh if mesh is not None else collectives.get_mesh()
    n_stages = mesh.shape[axis]
    n_micro = n_micro or n_stages
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         "micro-batches")
    mb = B // n_micro
    micros = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    if extra_specs is not None:
        micros = shard_of(micros, extra_specs, mesh, mesh.rank)
    stage = mesh.coord(axis)
    params = tree_map(lambda a: a[stage], stage_params)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    steps = n_micro + n_stages - 1
    perm = ring(n_stages)

    buf = torch.zeros_like(micros[0])
    outs = [torch.zeros_like(micros[0]) for _ in range(n_micro)]
    for t in range(steps):
        # Stage 0 injects micro-batch t; the others take the ring buffer.
        inject = t if t < n_micro else 0
        h = stage_fn(params, torch.where(first, micros[inject], buf))
        # The last stage stores finished micro-batch t - (n_stages - 1).
        out_idx = t - (n_stages - 1)
        if out_idx >= 0:
            outs[out_idx] = torch.where(last, h.to(outs[out_idx].dtype),
                                        outs[out_idx])
        buf = collectives.ppermute(h, axis, perm, mesh)
    out = torch.stack(outs)
    if n_stages > 1:
        # Every rank gets the last stage's outputs: a gather over the
        # pipeline axis, whose backward is this rank's own slice.
        out = collectives.gather_on_use(out[None], axis, 0,
                                        mesh)[n_stages - 1]
    return out.reshape((-1,) + tuple(out.shape[2:]))
