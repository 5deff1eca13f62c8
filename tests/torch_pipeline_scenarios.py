"""Pipeline scenarios for the port's pipeline tests, run on every rank of a
spawned ("pod", ...) mesh.

Spawned ranks import this module by its name in a fresh interpreter, so
it imports neither jax nor the reference package. A scenario is a dict:

    W (numpy, (n_stages, d, d)), x (numpy, (B, d)), cot (numpy, (B, d):
    the cotangent of y), n_micro, mutant (the ring sends to s - 1),
    extra_specs, device (default "cpu").

:func:`pipeline_rank` returns, per scenario, this rank's y, the
gradients of sum(y * cot) with respect to x and to its stage's slice of
W, its calls of the stage function and the collectives of the forward
alone.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel import collectives, pipeline


def _stage_fn(calls):
    def fn(w, h):
        calls.append(tuple(h.shape))
        return torch.tanh(h @ w)
    return fn


def _backwards(n):
    return [(i, (i - 1) % n) for i in range(n)]


def _one(mesh, spec: dict) -> dict:
    dev = spec.get("device", "cpu")
    W = torch.from_numpy(spec["W"]).to(dev)
    x = torch.from_numpy(spec["x"]).to(dev)
    cot = torch.from_numpy(spec["cot"]).to(dev)
    kw = dict(axis="pod", n_micro=spec["n_micro"],
              extra_specs=spec.get("extra_specs"))
    calls = []
    real = pipeline.ring
    if spec.get("mutant"):
        pipeline.ring = _backwards
    try:
        collectives.reset_stats(mesh)
        with torch.no_grad():
            y0 = pipeline.pipeline_forward(_stage_fn(calls), W, x, mesh, **kw)
        fwd = collectives.stats(mesh)
        out = dict(y=y0.cpu().numpy(), calls=calls, stats=fwd,
                   stage=mesh.coord("pod"), device=str(y0.device))
        if spec.get("extra_specs") is None:
            Wg = W.clone().requires_grad_(True)
            xg = x.clone().requires_grad_(True)
            y = pipeline.pipeline_forward(_stage_fn([]), Wg, xg, mesh, **kw)
            torch.sum(y * cot).backward()
            s = out["stage"]
            out.update(y_grad_run=y.detach().cpu().numpy(),
                       x_grad=xg.grad.cpu().numpy(),
                       w_grad=Wg.grad[s].cpu().numpy(),
                       w_grad_others=float(torch.cat([
                           Wg.grad[:s], Wg.grad[s + 1:]]).abs().sum()))
    finally:
        pipeline.ring = real
    return out


def pipeline_rank(mesh, specs) -> list:
    """Every scenario on this rank of ``mesh``."""
    return [_one(mesh, spec) for spec in specs]


def trace_counts(spec: dict) -> dict:
    """The collectives of the same forward traced on a ("pod",) trace
    mesh of the scenario's stage count, on the meta device."""
    from repro_torch.launch.mesh import trace_mesh

    n = spec["W"].shape[0]
    mesh = trace_mesh((n,), ("pod",))
    W = torch.empty(spec["W"].shape, device="meta")
    x = torch.empty(spec["x"].shape, device="meta")
    with torch.no_grad():
        y = pipeline.pipeline_forward(_stage_fn([]), W, x, mesh,
                                      n_micro=spec["n_micro"])
    return dict(stats=collectives.stats(mesh), shape=tuple(y.shape))


def numpy_case(n_stages: int, B: int = 8, d: int = 16, seed: int = 0):
    """The reference test's operands (stage weights at 0.3 scale, unit
    normal x), drawn with numpy, and a unit normal cotangent."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, d)).astype(np.float32)
    cot = rng.standard_normal((B, d)).astype(np.float32)
    return W, x, cot
