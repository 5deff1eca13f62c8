#!/usr/bin/env python3
"""How far the tensor-parallel Mamba2 mixer's f32 training step sits from
one rank's, and from an f64 step: ``chip_smoke.py`` phase 17 (a)'s f32
step on gloo ranks.

    python3 tools/ssm_tp_witness.py [--mesh 1,2] [--device cuda:0]
    python3 tools/ssm_tp_witness.py --plant NAME [...]

mamba2-2.7b at its published widths cut to ``SSM_TP_LAYERS`` layers,
phase 12's first batch (8 x 512 tokens), plain tensor parallelism,
the same weights in f32 and in f64 (drawn on the device in f32; the
"f64" step's SSD scan, its ``dt``, ``A_log`` and ``D``, and its norms
still run in f32, the reference's dtype points, so only its products
and sums outside them are f64). For
each dtype, every rank's step on the mesh gathered whole, and one
rank's step on the whole model; printed per gradient leaf as one JSON
line: its name, its largest magnitude, and the share of
``SSM_TP_TOL``'s allowance (rtol |b| + atol max |b|: at most 1 passes)
that each pair uses at its worst element, and the 2-norm of each
pair's difference over the whole leaf (``*_l2``; ``allow_l2``: the
allowance's):

    mesh_one      the mesh's step against one rank's (phase 17's check)
    one_f64       one rank's f32 step against one rank's f64 step
    mesh_f64      the mesh's f32 step against one rank's f64 step
    mesh_one_f64  the mesh's f64 step against one rank's f64 step

A few minutes on one card (every rank on it, over gloo).

``--plant NAME`` instead runs phase 17's own f32 check
(``chip_smoke.ssm_tp_step_f32``) with a fault planted in every rank and
prints, per rank, what that check reads (``f64`` and ``floor``:
``chip_smoke.rounding_reading``'s largest, held to ``SSM_TP_F64`` and
``SSM_TP_FLOOR``; ``elem``; ``excess``; the loss's and grad norm's
errors), plain TP and ``seq_shard``. The faults (:data:`PLANTS`):

    cols_slice_bwd   in_proj's and the conv's columns gathered with
                     ``gather_on_use``'s backward (this rank's slice of
                     its own cotangent, unsummed)
    norm_local_sum   the gated norm's sum of squares over this rank's
                     channels only
    head_no_sum      the vocab-cut head's input without its gradient
                     summed over 'model' (``tp_open`` an identity)
    tf32_mesh        the mesh's f32 steps with TF32 products (a loss of
                     precision alone: the f64 steps are untouched)
    none             no fault (the check as phase 17 runs it)
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _names(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{pre}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _names(v, f"{pre}/{i}")
    else:
        yield pre


def _mesh_grads(torch, cs, mesh, cfg, full, batch):
    """Every rank's gradients of one step on ``mesh``, gathered whole."""
    from repro_torch.checkpoint.manager import gather_whole
    from repro_torch.models import model as model_lib
    from repro_torch.models.modules import iter_leaves
    from repro_torch.parallel import sharding as shd
    params, specs = shd.train_shard_params(full, mesh)
    leaves = list(iter_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    plan = shd.TrainPlan(mesh, cfg, specs, params,
                         shd.batch_axes(mesh, cs.TRAIN["batch"]))
    with shd.use_plan(plan):
        total, _, _ = model_lib.loss_terms(params, cfg, batch)
        total.backward()
    return gather_whole([p.grad for p in leaves],
                        list(shd.iter_leaves_specs(specs)), mesh)


def witness_rank(mesh, device):
    import torch
    import chip_smoke as cs
    from repro_torch.models import model as model_lib
    from repro_torch.models import modules
    # The port's configs name bf16 and f32 only; the f64 witness runs
    # the same code on f64 tensors.
    modules.DTYPES.setdefault("float64", torch.float64)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    batch = {"tokens": torch.from_numpy(
        next(cs.train_data())["tokens"]).to(dev)}
    mesh_g, one_g = {}, {}
    for dtype in ("float32", "float64"):
        cfg = cs.ssm_tp_config(dtype)
        with cs.drawn_on_card(torch):
            full = model_lib.init_params(cfg, seed=cs.TRAIN["seed"],
                                         device=dev)
        mesh_g[dtype] = [g.cpu() for g in _mesh_grads(torch, cs, mesh, cfg,
                                                      full, batch)]
        if mesh.rank == 0:
            _, want = cs.value_and_grads(torch, cfg, full, batch)
            one_g[dtype] = [g.cpu() for g in want]
        del full
        torch.cuda.empty_cache()
    if mesh.rank != 0:
        return []
    names = list(_names(model_lib.init_params(
        cs.ssm_tp_config("float32"), device="meta")))
    out = []
    for k, name in enumerate(names):
        m32, m64 = mesh_g["float32"][k], mesh_g["float64"][k]
        o32, o64 = one_g["float32"][k], one_g["float64"][k]
        scale = float(o64.abs().max())
        row = dict(leaf=name, scale=scale)
        for key, a, b in (("mesh_one", m32, o32), ("one_f64", o32, o64),
                          ("mesh_f64", m32, o64),
                          ("mesh_one_f64", m64, o64)):
            row[key] = cs.allowance_used(a, b)
            row[key + "_l2"] = float(torch.linalg.vector_norm(
                a.double() - b.double()))
        row["allow_l2"] = float(torch.linalg.vector_norm(
            cs.SSM_TP_TOL["atol"] * scale
            + cs.SSM_TP_TOL["rtol"] * o64.double().abs()))
        out.append(row)
    return out


def _plant(name):
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    if name == "cols_slice_bwd":
        ssm._open_cols = lambda t, axis: collectives.gather_on_use(
            t, axis, t.dim() - 1)
    elif name == "norm_local_sum":
        collectives.tp_sum = lambda x, axes, mesh=None: x
    elif name == "head_no_sum":
        logits = model_lib._logits

        def no_sum(params, cfg, x, mesh=None):
            tp_open = collectives.tp_open
            collectives.tp_open = lambda x, axes, mesh=None: x
            try:
                return logits(params, cfg, x, mesh)
            finally:
                collectives.tp_open = tp_open
        model_lib._logits = no_sum
    elif name == "tf32_mesh":
        # The one-rank steps run first; every step after them is the
        # mesh's, and TF32 changes only its f32 products.
        loss_terms = model_lib.loss_terms

        def tf32(params, cfg, batch):
            if shd.current_plan() is not None:
                torch.backends.cuda.matmul.allow_tf32 = True
            return loss_terms(params, cfg, batch)
        model_lib.loss_terms = tf32


PLANTS = ("none", "cols_slice_bwd", "norm_local_sum", "head_no_sum",
          "tf32_mesh")


def plant_rank(mesh, name, device):
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    _plant(name)
    got = cs.ssm_tp_step_f32(torch, torch.device(device), mesh)
    keys = ("f64", "worst_f64", "floor", "worst_floor", "elem", "excess",
            "loss", "gnorm")
    return [dict(plant=name, rank=mesh.rank, step=k,
                 **{x: got[k][x] for x in keys}) for k in ("tp", "sp")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,2")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--plant", choices=PLANTS)
    args = ap.parse_args(argv)
    import chip_smoke as cs
    from repro_torch.launch.mesh import spawn_mesh
    shape = tuple(int(s) for s in args.mesh.split(","))
    print(cs.gpu_name_and_power(), flush=True)
    if args.plant:
        outs = spawn_mesh(plant_rank, shape, (args.plant, args.device),
                          device=args.device, backend="gloo",
                          axes=("data", "model"), timeout_s=600.0)
        for rows in outs:
            for row in rows:
                print(json.dumps(row), flush=True)
        return 0
    outs = spawn_mesh(witness_rank, shape, (args.device,),
                      device=args.device, backend="gloo",
                      axes=("data", "model"), timeout_s=600.0)
    for row in outs[0]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
