"""Sequence-parallel scenarios for the port's mesh tests, run on every rank
of a spawned (pod, data, model) mesh.

Spawned ranks import this module by its name in a fresh interpreter, so
it imports neither jax nor the reference package. :func:`sp_rank` runs a
list of scenarios, each a dict with ``kind``:

    train    ``torch_train_scenarios``' training scenario (its fields),
             optionally under one of :data:`SP_MUTANTS`
    prefill  ``model.forward`` into contiguous caches under a plan, the
             caches laid out as the dry run lays a prefill's: the
             logits and the caches, gathered whole
    decode   a prefill on one host, its caches cut as the dry run cuts
             a long-context decode's (batch 1: the rows over 'data'),
             then ``steps`` decode steps under a plan whose
             ``cache_rows`` name that cut: each step's logits, the
             global rows each step changed in this rank's slice of the
             attention caches, and the caches gathered whole at the end
    prims    the four sequence-parallel primitives (:func:`prims_rank`)

:func:`run_prefill` and :func:`run_decode` are the same scenarios on one
host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
import torch_train_scenarios as ts


# ------------------------------------------------------------- mutants
def _plain_slice(x, axis="model", dim=1, mesh=None):
    """This rank's slice with autograd's own backward: the slice's
    gradient padded with zeros, where seq_split gathers the ranks'."""
    m = collectives._mesh(mesh)
    size = x.shape[dim] // m.group_size(axis)
    return x.narrow(dim, m.coord(axis) * size, size)


def _open_all_gather(x):
    return collectives.sp_open(x, "model", 1)


# name -> [(module, attribute, replacement)]: each breaks one rule of
# the layout, and the sharded step must then fail the parity checks.
SP_MUTANTS = {
    # A region every rank computes alike, opened as a tensor-parallel one
    # (its gradient reduce-scattered) and closed by a plain slice: the
    # activations' gradients come out right, but each rank's gathered
    # weights get the gradient of its own tokens only.
    "alike_region_sp_open": [(tfm, "_region_open", _open_all_gather),
                             (tfm, "_region_close", _plain_slice)],
    # A norm on the sequence shard whose scale gradient is not summed
    # over 'model'.
    "norm_scale_not_summed": [(tfm, "_shard_scale", lambda s: s)],
    # seq_split as a plain slice.
    "seq_split_plain_slice": [(collectives, "seq_split", _plain_slice)],
}


def _apply(name):
    if name is None:
        return lambda: None
    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _ in SP_MUTANTS[name]]
    for mod, attr, fn in SP_MUTANTS[name]:
        setattr(mod, attr, fn)

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def sp_rank(mesh, specs) -> list:
    """Every scenario on this rank of ``mesh``."""
    out = []
    for spec in specs:
        if spec["kind"] == "train":
            undo = _apply(spec.get("sp_mutant"))
            try:
                out.append(ts._train_one(mesh, spec))
            finally:
                undo()
        elif spec["kind"] == "prefill":
            out.append(run_prefill(spec, mesh))
        elif spec["kind"] == "prims":
            out.extend(prims_rank(mesh, [spec]))
        else:
            out.append(run_decode(spec, mesh))
    return out


# ------------------------------------------------------------- helpers
def _pairs(tree, specs):
    """(leaf, spec) of a cache tree and its spec tree, in a fixed order."""
    out = []
    dryrun._zip_map(lambda _, leaf, spec: out.append((leaf, spec)), tree,
                    specs)
    return out


def _leaves(tree):
    out = []
    dryrun._zip_map(lambda _, leaf, __: out.append(leaf), tree, tree)
    return out


def _whole(caches, specs, mesh):
    leaves, sp = zip(*_pairs(caches, specs))
    return ts._np(ckpt.gather_whole(list(leaves), list(sp), mesh))


# ------------------------------------------------------------- prefill
def run_prefill(spec: dict, mesh=None) -> dict:
    """Prefill of ``spec["B"]`` prompts of ``spec["S"]`` tokens into
    caches of ``spec["rows"]`` rows, whole on one host (``mesh`` None)
    or on this rank under its plan: the logits and every cache leaf,
    gathered whole."""
    cfg = ts.scenario_config(spec)
    full = ts.scenario_params(cfg, spec)
    B, S, R = spec.get("B", 4), spec.get("S", 16), spec["rows"]
    whole = ts._on(ts.scenario_batch(cfg, spec), spec)
    caches = model_lib.init_caches(cfg, B, R, device="cpu")
    if mesh is None:
        with torch.no_grad():
            logits, new, _ = model_lib.forward(full, cfg, whole, caches)
        return {"logits": ts._np([logits])[0],
                "caches": ts._np(_leaves(new))}
    params, pspecs = shd.train_shard_params(full, mesh)
    shape = ShapeConfig("p", R, B, "prefill")
    bspecs = shd.batch_spec(cfg, shape, mesh, whole)
    batch = {k: shd.shard_of(v, bspecs[k], mesh, mesh.rank)
             for k, v in whole.items()}
    axes = shd.batch_axes(mesh, B)
    plan, cspecs = dryrun.cache_plan(cfg, shape, mesh, pspecs, params, axes,
                                     caches)
    assert not plan.cache_rows
    local = shd.cut_tree(caches, cspecs, mesh, mesh.rank)
    collectives.reset_stats(mesh)
    with torch.no_grad(), shd.use_plan(plan):
        logits, new, _ = model_lib.forward(params, cfg, batch, local)
    stats = collectives.stats(mesh)
    lspec = ((axes,) if axes else (None,)) + (None,) * (logits.dim() - 1)
    return {"logits": ts._np(ckpt.gather_whole([logits], [lspec], mesh))[0],
            "caches": _whole(new, cspecs, mesh), "stats": stats}


# -------------------------------------------------------------- decode
def decode_tokens(cfg, spec: dict) -> np.ndarray:
    rng = np.random.default_rng(spec.get("batch_seed", 0) + 1)
    return rng.integers(0, cfg.vocab_size,
                        (spec["steps"], 1, 1)).astype(np.int32)


def run_decode(spec: dict, mesh=None) -> dict:
    """A batch-1 prompt of ``spec["S"]`` tokens prefilled on one host into
    caches of ``spec["rows"]`` rows, then ``spec["steps"]`` decode steps:
    whole on one host (``mesh`` None), or on this rank with its slice of
    the caches under a plan whose ``cache_rows`` are the dry run's cut.
    Returns each step's logits, the global rows each step changed in
    this rank's attention caches, and the caches, gathered whole."""
    cfg = ts.scenario_config(spec)
    full = ts.scenario_params(cfg, spec)
    R = spec["rows"]
    prompt = ts._on(ts.scenario_batch(cfg, dict(spec, B=1)), spec)
    with torch.no_grad():
        _, caches = model_lib.prefill(full, cfg, prompt, R)
    toks = [torch.from_numpy(t) for t in decode_tokens(cfg, spec)]
    if mesh is None:
        params, plan, cspecs, j = full, None, None, 0
    else:
        params, pspecs = shd.train_shard_params(full, mesh)
        shape = ShapeConfig("d", R, 1, "decode")
        plan, cspecs = dryrun.cache_plan(cfg, shape, mesh, pspecs, params,
                                         shd.batch_axes(mesh, 1), caches)
        caches = shd.cut_tree(caches, cspecs, mesh, mesh.rank)
        j = 0
        for a in plan.cache_rows:
            j = j * mesh.shape[a] + mesh.coord(a)
        collectives.reset_stats(mesh)
    attn = _attn_leaves(caches)
    first = j * attn[0].shape[2]
    out = {"logits": [], "changed": [], "first": first,
           "rows_here": attn[0].shape[2]}
    for t in toks:
        before = [a.clone() for a in attn]
        with torch.no_grad(), shd.use_plan(plan):
            logits, caches = model_lib.decode_step(params, cfg, t, caches)
        changed = set()
        for a, b in zip(attn, before):
            # (layers, B, rows, ...): the rows where anything changed.
            diff = (a != b).reshape(a.shape[0], a.shape[1], a.shape[2], -1)
            changed |= {first + int(r) for r in
                        torch.nonzero(diff.any(-1).any(0).any(0))[:, 0]}
        out["logits"].append(logits[:, -1].numpy().copy())
        out["changed"].append(sorted(changed))
    if mesh is None:
        out["caches"] = ts._np(_leaves(caches))
    else:
        out["stats"] = collectives.stats(mesh)
        out["caches"] = _whole(caches, cspecs, mesh)
        out["cache_rows"] = plan.cache_rows
    return out


def _attn_leaves(caches):
    """The attention caches' k and v leaves (layer-stacked, rows on dim
    2)."""
    out = []
    dryrun._zip_map(lambda path, leaf, _: out.append(leaf)
                    if path[-1] in ("k", "v") else None, caches, caches)
    return out


# ---------------------------------------------------------- primitives
PRIM_SHAPE = (3, 8, 5)  # (B, S, d), the sequence over 'model'


def prim_inputs(n: int):
    """Each rank's x (its slice for seq_gather/sp_open, a whole tensor
    for seq_split/sp_close) and the cotangents, seeded."""
    rng = np.random.default_rng(11)
    B, S, d = PRIM_SHAPE
    shard = rng.standard_normal((n, B, S // n, d)).astype(np.float32)
    whole = rng.standard_normal((n, B, S, d)).astype(np.float32)
    cot_whole = rng.standard_normal((n, B, S, d)).astype(np.float32)
    cot_shard = rng.standard_normal((n, B, S // n, d)).astype(np.float32)
    return shard, whole, cot_whole, cot_shard


def prims_rank(mesh, specs) -> list:
    """``seq_split``, ``seq_gather``, ``sp_open`` and ``sp_close`` over
    'model' on ``spec["device"]``: each one's output and the gradient of
    sum(out * cot) with respect to its input, on the host, and the
    collectives counted."""
    out = []
    for spec in specs:
        dev = torch.device(spec["device"])
        r = mesh.coord("model")
        shard, whole, cot_whole, cot_shard = prim_inputs(
            mesh.shape["model"])
        res = {}
        collectives.reset_stats(mesh)
        for name, x, cot in (("seq_split", whole, cot_shard),
                             ("seq_gather", shard, cot_whole),
                             ("sp_open", shard, cot_whole),
                             ("sp_close", whole, cot_shard)):
            xt = torch.from_numpy(x[r]).to(dev).requires_grad_(True)
            y = getattr(collectives, name)(xt, "model", 1)
            torch.sum(y * torch.from_numpy(cot[r]).to(dev)).backward()
            res[name] = (y.detach().cpu().numpy(), xt.grad.cpu().numpy(),
                         y.device.type)
        res["stats"] = collectives.stats(mesh)
        out.append(res)
    return out
