"""Tensor-parallel Mamba2 scenarios for the port's mesh tests, run on every
rank of a spawned (data, model) mesh.

Spawned ranks import this module by its name in a fresh interpreter, so
it imports neither jax nor the reference package. :func:`tp_rank` runs a
list of scenarios, each a dict with ``kind``:

    train    ``torch_train_scenarios``' training scenario (its fields),
             optionally under one of :data:`MUTANTS`
    prefill  ``model.forward`` of ``B`` prompts of ``S`` tokens into
             contiguous caches of ``rows`` rows under a plan, the caches
             laid out as the dry run lays a prefill's
    decode   that prefill on one host, its caches cut as the dry run
             cuts a decode's, then ``steps`` decode steps under the plan

A prefill or decode returns the logits (each step's, for a decode) and
every cache leaf gathered whole, and this rank's own ssm states' shapes
and conv windows (:func:`_own`). :func:`run_cached` is the same scenario
on one host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.models import ssm
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
import torch_train_scenarios as ts


# ------------------------------------------------------------- mutants
def _cols_slice_bwd(t, axis):
    """The columns gathered with ``gather_on_use``'s backward: this
    rank's slice of its own cotangent, unsummed."""
    return collectives.gather_on_use(t, axis, t.dim() - 1)


def _local_sum(x, axes, mesh=None):
    return x


# name -> [(module, attribute, replacement)]: each breaks one rule of the
# tensor-parallel mixer or MLA's latents, and the sharded step must then
# fail the parity checks.
MUTANTS = {
    # in_proj's (and the conv's) columns gathered with a slicing backward.
    "cols_slice_bwd": [(ssm, "_open_cols", _cols_slice_bwd)],
    # The gated norm's sum of squares over this rank's channels only.
    "norm_local_sum": [(collectives, "tp_sum", _local_sum)],
    # The sum of squares summed forward, its backward not summed.
    "norm_sum_bwd_identity": [(collectives, "tp_sum", collectives.tp_close)],
    # MLA's latents gathered with a slicing backward.
    "mla_latent_slice_bwd": [(attention, "_open_latent", _cols_slice_bwd)],
}


def _apply(name):
    if name is None:
        return lambda: None
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in MUTANTS[name]]
    for mod, attr, fn in MUTANTS[name]:
        setattr(mod, attr, fn)

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def tp_rank(mesh, specs) -> list:
    """Every scenario on this rank of ``mesh``."""
    out = []
    for spec in specs:
        if spec["kind"] == "train":
            undo = _apply(spec.get("mutant"))
            try:
                out.append(ts._train_one(mesh, spec))
            finally:
                undo()
        else:
            out.append(run_cached(spec, mesh))
    return out


# ------------------------------------------------------------- helpers
def _pairs(tree, specs):
    out = []
    dryrun._zip_map(lambda path, leaf, spec: out.append((path, leaf, spec)),
                    tree, specs)
    return out


def _own(caches, cspecs):
    """This rank's ssm states' shapes and conv windows (numpy)."""
    h, conv = [], []
    for path, leaf, _ in _pairs(caches, cspecs):
        if path[-1] == "h":
            h.append(tuple(leaf.shape))
        elif path[-1] == "conv":
            conv.append(leaf.numpy().copy())
    return h, conv


def _whole(caches, cspecs, mesh):
    _, leaves, specs = zip(*_pairs(caches, cspecs))
    return ts._np(ckpt.gather_whole(list(leaves), list(specs), mesh))


def decode_tokens(cfg, spec: dict) -> list:
    rng = np.random.default_rng(spec.get("batch_seed", 0) + 1)
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    return [torch.from_numpy(t) for t in rng.integers(
        0, cfg.vocab_size, (spec["steps"], spec.get("B", 4)) + lead + (1,)
    ).astype(np.int32)]


# ------------------------------------------------- prefill and decode
def run_cached(spec: dict, mesh=None) -> dict:
    """The prefill (``kind`` "prefill"; its last position's logits only
    with ``last_only``) or the decode steps after a one-host prefill
    (``kind`` "decode") of ``spec``, whole on one host (``mesh`` None)
    or on this rank under its plan, the caches cut by the dry run's
    layout for the shape."""
    cfg = ts.scenario_config(spec)
    full = ts.scenario_params(cfg, spec)
    B, R = spec.get("B", 4), spec["rows"]
    prompt = ts._on(ts.scenario_batch(cfg, spec), spec)
    decode = spec["kind"] == "decode"
    if decode:
        with torch.no_grad():
            _, caches = model_lib.prefill(full, cfg, prompt, R)
    else:
        caches = model_lib.init_caches(cfg, B, R, device="cpu")
    steps = ([{"tokens": t} for t in decode_tokens(cfg, spec)] if decode
             else [prompt])
    last = dict(last_only=spec.get("last_only", False))
    out = {"logits": []}
    if mesh is None:
        for batch in steps:
            with torch.no_grad():
                logits, caches, _ = model_lib.forward(full, cfg, batch,
                                                      caches, **last)
            out["logits"].append(ts._np([logits])[0])
        out["caches"] = ts._np([leaf for _, leaf, _ in
                                _pairs(caches, caches)])
        return out
    params, pspecs = shd.train_shard_params(full, mesh)
    shape = ShapeConfig("c", R, B, spec["kind"])
    axes = shd.batch_axes(mesh, B)
    plan, cspecs = dryrun.cache_plan(cfg, shape, mesh, pspecs, params, axes,
                                     caches)
    caches = shd.cut_tree(caches, cspecs, mesh, mesh.rank)
    lspec = None
    collectives.reset_stats(mesh)
    for whole in steps:
        bspecs = shd.batch_spec(cfg, shape, mesh, whole)
        batch = {k: shd.shard_of(v, bspecs[k], mesh, mesh.rank)
                 for k, v in whole.items()}
        with torch.no_grad(), shd.use_plan(plan):
            logits, caches, _ = model_lib.forward(params, cfg, batch, caches,
                                                  **last)
        lspec = ((axes,) if axes else (None,)) + (None,) * (logits.dim() - 1)
        out["logits"].append(ts._np(ckpt.gather_whole(
            [logits], [lspec], mesh))[0])
    out["stats"] = collectives.stats(mesh)
    out["h_shapes"], out["conv"] = _own(caches, cspecs)
    out["caches"] = _whole(caches, cspecs, mesh)
    out["mixer_tp"] = plan.mixer_tp(cfg)
    return out
