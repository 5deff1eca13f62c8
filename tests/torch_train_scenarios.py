"""Training scenarios for the port's mesh tests, run the same way on one
host and on every rank of a spawned (pod, data, model) mesh.

Spawned ranks import this module by its name in a fresh interpreter, so
it imports neither jax nor the reference package. A scenario is a dict:

    name, arch, fields (config fields to replace; ``sparsity`` as a dict
    of its fields), B, S, steps, seed (weights; or ``weights``, a numpy
    tree of the port's layout), batch_seed, mask_tail, zero1,
    mutant (a collective to break on the ranks, see :data:`MUTANTS`),
    device (default "cpu").

:func:`run_single` and :func:`train_rank` return what a run decides: the
first step's loss, aux loss, grad norm, skip counters and gradients,
and the params and moments after ``steps`` steps, all whole (a rank
gathers its slices); a rank adds the shapes of the slices it stores and
a digest of its params.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.models import model as model_lib
from repro_torch.models.modules import iter_leaves, tree_map
from repro_torch.optim.adamw import AdamW, opt_state_shardings
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import trainer as trainer_lib


def scenario_config(spec: dict):
    cfg = get_config(spec["arch"]).reduced()
    fields = dict(spec.get("fields", {}))
    if fields.get("sparsity") is not None:
        fields["sparsity"] = SparsityConfig(**fields["sparsity"])
    return dataclasses.replace(cfg, **fields)


def scenario_batch(cfg, spec: dict, step: int = 0) -> dict:
    """Seeded numpy batch (the one every rank draws whole)."""
    B, S = spec.get("B", 4), spec.get("S", 16)
    rng = np.random.default_rng((spec.get("batch_seed", 0), step))
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B,) + lead + (S,)).astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    tail = spec.get("mask_tail", 0)
    if tail:
        mask = np.ones((B, S), np.float32)
        mask[: B // 2, S - tail:] = 0.0  # rows differ: the shards' means do
        batch["loss_mask"] = mask
    return batch


def scenario_params(cfg, spec: dict):
    dev = spec.get("device", "cpu")
    if spec.get("weights") is not None:
        return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev),
                        spec["weights"])
    return model_lib.init_params(cfg, seed=spec.get("seed", 0), device=dev)


def _on(batch: dict, spec: dict) -> dict:
    return {k: torch.from_numpy(v).to(spec.get("device", "cpu"))
            for k, v in batch.items()}


class SpyAdamW(AdamW):
    """AdamW that keeps the gradients it is handed (this rank's)."""

    def update(self, grads, state, params, shard=None):
        object.__getattribute__(self, "seen").append(
            [g.clone() for g in iter_leaves(grads)])
        return super().update(grads, state, params, shard)


def _optimizer() -> SpyAdamW:
    opt = SpyAdamW(lr=1e-3)
    object.__setattr__(opt, "seen", [])
    return opt


def _np(xs):
    return [x.detach().float().cpu().numpy().copy() for x in xs]


def run_single(spec: dict) -> dict:
    """The scenario on this host, no mesh."""
    cfg = scenario_config(spec)
    params = scenario_params(cfg, spec)
    opt = _optimizer()
    state = opt.init(params)
    step = trainer_lib.make_train_step(cfg, opt)
    out = {}
    for i in range(spec.get("steps", 1)):
        batch = _on(scenario_batch(cfg, spec, i), spec)
        if i == 0:
            with torch.no_grad():
                _, _, aux = model_lib.forward(params, cfg, batch)
            out["skip"] = aux["skip"].cpu().numpy().tolist()
        params, state, m = step(params, state, batch)
        if i == 0:
            out.update(loss=float(m["loss"]), aux_loss=float(m["aux_loss"]),
                       grad_norm=float(m["grad_norm"]),
                       grads=_np(opt.seen[0]))
    out["params"] = _np(iter_leaves(params))
    out["mu"] = _np(iter_leaves(state.mu))
    out["nu"] = _np(iter_leaves(state.nu))
    return out


# A mutant breaks one collective on every rank; the tests that hold the
# sharded step against one host must then fail.
def _psum_bwd_allreduces(x, axes, mesh=None):
    return collectives._Open.apply(collectives.psum(x.clone(), axes, mesh),
                                   axes, mesh)


def _open_without_bwd(x, axes, mesh=None):
    return x


def _norm_sums_everything(tree, shard=None):
    if shard is None:
        return _REAL_NORM(tree)
    cut = sum(torch.sum(torch.square(x.float())) for x in iter_leaves(tree))
    cut = collectives.psum(cut.reshape(1), "model", shard.mesh)[0]
    return torch.sqrt(cut)


_REAL_NORM = None
MUTANTS = {
    "psum_bwd_allreduce": ("tp_close", _psum_bwd_allreduces),
    "mirror_no_bwd": ("tp_open", _open_without_bwd),
    "norm_sums_replicated": ("global_norm", _norm_sums_everything),
}


def _apply_mutant(name):
    """Break the named collective in this process; returns the undo."""
    global _REAL_NORM
    if name is None:
        return lambda: None
    target, fn = MUTANTS[name]
    from repro_torch.optim import adamw  # noqa: PLC0415
    module = adamw if target == "global_norm" else collectives
    real = getattr(module, target)
    _REAL_NORM = adamw.global_norm
    setattr(module, target, fn)
    return lambda: setattr(module, target, real)


def train_rank(mesh, specs) -> list:
    """Every scenario on this rank of ``mesh``; rank 0's results hold the
    whole trees, the others' only their shapes and digests."""
    out = []
    for spec in specs:
        undo = _apply_mutant(spec.get("mutant"))
        try:
            out.append(_train_one(mesh, spec))
        finally:
            undo()
    return out


def _train_one(mesh, spec: dict) -> dict:
    cfg = scenario_config(spec)
    full = scenario_params(cfg, spec)
    opt = _optimizer()
    params, specs = shd.train_shard_params(full, mesh)
    mspecs = list(shd.iter_leaves_specs(opt_state_shardings(
        opt.init(full), specs, mesh, zero1=spec.get("zero1", False)).mu))
    pspecs = list(shd.iter_leaves_specs(specs))
    r = mesh.rank
    state = trainer_lib.init_moments(full, mspecs, mesh)
    shape = ShapeConfig("t", spec.get("S", 16), spec.get("B", 4), "train")
    res = {"param_shapes": [tuple(p.shape) for p in iter_leaves(params)],
           "moment_shapes": [tuple(m.shape) for m in iter_leaves(state.mu)]}
    collectives.reset_stats(mesh)
    from repro_torch.kernels import sparce_gemm  # noqa: PLC0415
    gated = sparce_gemm.sparce_gemm_gated.launches
    step = trainer_lib.make_train_step(
        cfg, opt, mesh, specs, mspecs,
        batch_axes=shd.batch_axes(mesh, spec.get("B", 4)))
    for i in range(spec.get("steps", 1)):
        whole = _on(scenario_batch(cfg, spec, i), spec)
        bspecs = shd.batch_spec(cfg, shape, mesh, whole)
        batch = {k: shd.shard_of(v, bspecs[k], mesh, r)
                 for k, v in whole.items()}
        params, state, m = step(params, state, batch)
        if i == 0:
            res.update(loss=float(m["loss"]), aux_loss=float(m["aux_loss"]),
                       grad_norm=float(m["grad_norm"]),
                       skip=m["skip"].cpu().numpy().tolist())
            grads = ckpt.gather_whole(opt.seen[0], pspecs, mesh)
    res["stats"] = collectives.stats(mesh)
    res["gated_launches"] = sparce_gemm.sparce_gemm_gated.launches - gated
    res["digest"] = hashlib.sha256(b"".join(
        p.cpu().numpy().tobytes() for p in iter_leaves(params))).hexdigest()
    params_w = ckpt.gather_whole(list(iter_leaves(params)), pspecs, mesh)
    mu_w = ckpt.gather_whole(list(iter_leaves(state.mu)), mspecs, mesh)
    nu_w = ckpt.gather_whole(list(iter_leaves(state.nu)), mspecs, mesh)
    if r == 0:
        res.update(grads=_np(grads), params=_np(params_w), mu=_np(mu_w),
                   nu=_np(nu_w))
    return res


# ------------------------------------------------------------ the Trainer
class Rewindable:
    """Batches keyed by step: a restart re-reads from the restored step,
    as a restarted job's iterator would."""

    def __init__(self, batches, pos: int = 0):
        self.batches, self.pos = batches, pos

    def __next__(self):
        self.pos += 1
        return self.batches[self.pos - 1]


def run_trainer(spec: dict, mesh=None) -> dict:
    """``Trainer.run`` on this host (``mesh`` None) or on this rank:
    ``steps`` steps from ``start`` (a checkpoint in ``ckpt_dir``),
    a fault at ``fault_at`` once (every rank raises at the same step)."""
    from repro_torch.checkpoint.manager import latest_step  # noqa: PLC0415
    from repro_torch.data import pipeline  # noqa: PLC0415
    from repro_torch.runtime.trainer import (  # noqa: PLC0415
        TrainConfig, Trainer,
    )

    cfg = scenario_config(spec)
    shape = ShapeConfig("t", spec.get("S", 16), spec.get("B", 4), "train")
    tc = TrainConfig(steps=spec["steps"], log_every=1,
                     ckpt_every=spec.get("ckpt_every", 100),
                     ckpt_dir=spec.get("ckpt_dir"), async_ckpt=False,
                     zero1=spec.get("zero1", False), seed=spec.get("seed", 0))
    tr = Trainer(cfg, shape, AdamW(lr=1e-3), tc, mesh=mesh, device="cpu")
    it = pipeline.make_batch_iterator(cfg, shape, pipeline.DataConfig(
        seed=spec.get("seed", 0)))
    data = Rewindable([next(it) for _ in range(spec["steps"])],
                      pos=spec.get("start", 0))
    crashed = []

    def fault(step):
        if step == spec.get("fault_at") and not crashed:
            crashed.append(step)
            data.pos = latest_step(spec["ckpt_dir"])
            raise RuntimeError("simulated preemption")

    out = tr.run(data, fault_hook=fault)
    leaves = list(iter_leaves(out["params"]))
    res = {"history": out["history"], "final_step": out["final_step"],
           "stragglers": out["straggler_events"],
           "digest": hashlib.sha256(b"".join(
               p.numpy().tobytes() for p in leaves)).hexdigest()}
    if mesh is not None:
        leaves = ckpt.gather_whole(leaves, list(shd.iter_leaves_specs(
            tr.specs)), mesh)
    res["params"] = _np(leaves)
    return res


def trainer_rank(mesh, specs) -> list:
    return [run_trainer(s, mesh) for s in specs]


# ------------------------------------------------ checkpoint gathering
GATHER_SPECS = [(("pod", "data"), "model"), (None, "model"),
                ("model", None), (None, None), (("data", "model"), None),
                ("data", None), ()]


def gather_leaves(mesh):
    """Whole seeded leaves of (8, 4) (the step's () a scalar), one per
    :data:`GATHER_SPECS` entry: f32, with one bf16 leaf."""
    rng = np.random.default_rng(5)
    out = []
    for i, spec in enumerate(GATHER_SPECS):
        a = torch.from_numpy(rng.standard_normal(
            (8, 4)[:len(spec)]).astype(np.float32))
        out.append(a.to(torch.bfloat16) if i == 1 else a)
    return out


def gather_rank(mesh, specs) -> list:
    """Each rank's slices of :func:`gather_leaves` on ``specs[0]
    ["device"]`` gathered by ``checkpoint.manager.gather_to_root``: rank
    0's whole leaves (None elsewhere) and this rank's collective
    counters."""
    whole = gather_leaves(mesh)
    mine = [shd.shard_of(a, s, mesh, mesh.rank).to(specs[0]["device"])
            for a, s in zip(whole, GATHER_SPECS)]
    collectives.reset_stats(mesh)
    got = ckpt.gather_to_root(mine, GATHER_SPECS, mesh)
    return [{"leaves": None if got is None else _np(got),
             "stats": collectives.stats(mesh)}]


# --------------------------------------------------- expert parallelism
def ep_rank(mesh, specs) -> list:
    """One MoE layer on this rank under the ambient plan, for each spec
    {params (numpy moe tree), x (numpy (B, S, d)), arch}: y, the aux
    loss, the slot sparsity, the kept assignments and the gradients of
    sum(y**2) + aux, all whole."""
    from repro_torch.models import moe as moe_lib  # noqa: PLC0415

    out = []
    for spec in specs:
        cfg = scenario_config(spec)
        full = {"moe": tree_map(lambda a: torch.from_numpy(np.array(a)),
                                spec["params"])}
        specs_ = shd.param_specs(full, mesh)
        local = shd.cut_tree(full, specs_, mesh, mesh.rank)
        x_full = torch.from_numpy(np.array(spec["x"]))
        axes = ("data",)
        x = shd.shard_of(x_full, (axes, None, None), mesh, mesh.rank)
        leaves = list(iter_leaves(local))
        for p in leaves + [x]:
            p.requires_grad_(True)
        plan = shd.TrainPlan(mesh, cfg, specs_, local, batch_axes=axes)
        with shd.use_plan(plan):
            y, aux, ss = moe_lib.moe_forward(local["moe"], x, cfg)
            obj = collectives.psum_replicas(torch.sum(y * y), axes) + aux
            obj.backward()
        n = plan.batch_size
        grads = trainer_lib.average_grads([p.grad for p in leaves], axes,
                                          mesh)
        pspecs = list(shd.iter_leaves_specs(specs_))
        M = mesh.shape["model"]
        E_loc = cfg.moe.num_experts // M
        C = moe_lib.capacity(x.shape[0] * x.shape[1], cfg)
        whole = ckpt.gather_whole(grads + [x.grad / n, y.detach()],
                                  pspecs + [(axes, None, None)] * 2, mesh)
        out.append({
            "aux": float(aux), "slot_sparsity": float(ss),
            "kept": int(round((1.0 - float(ss)) * mesh.size * E_loc * C)),
            "grads": _np(whole[:-2]), "x_grad": _np(whole[-2:-1])[0],
            "y": _np(whole[-1:])[0], "stats": collectives.stats(mesh)})
    return out


# ----------------------------------------------------- compressed_psum
def compress_rank(mesh, specs) -> list:
    """compressed_psum of this rank's gradient (``grads[round][rank]``),
    round after round with error feedback, on ``device``."""
    from repro_torch.optim import compress  # noqa: PLC0415

    out = []
    for spec in specs:
        dev = spec.get("device", "cpu")
        r = torch.zeros(spec["shape"], dtype=torch.float32, device=dev)
        res = []
        collectives.reset_stats(mesh)
        for g in spec["grads"]:
            g = torch.from_numpy(np.array(g[mesh.rank])).to(dev)
            avg, new = compress.compressed_psum({"w": g}, {"w": r}, "data",
                                                method=spec["method"])
            r = new["w"]
            res.append((avg["w"].cpu().numpy(), r.cpu().numpy()))
        out.append({"rounds": res, "stats": collectives.stats(mesh)})
    return out


# ---------------------------------------------------- the dry run's counts
def count_rank(mesh, spec) -> dict:
    """One sharded training step of the scenario on this rank, built as
    the dry run builds its program (AdamW(lr=3e-4), the moments by
    ``opt_state_shardings``, the batch cut by ``batch_spec``): the
    step's collectives alone."""
    cfg = scenario_config(spec)
    full = scenario_params(cfg, spec)
    opt = AdamW(lr=3e-4)
    params, specs = shd.train_shard_params(full, mesh)
    mspecs = list(shd.iter_leaves_specs(opt_state_shardings(
        opt.init(full), specs, mesh, zero1=spec.get("zero1", False)).mu))
    state = trainer_lib.init_moments(full, mspecs, mesh)
    B, S = spec.get("B", 4), spec.get("S", 16)
    shape = ShapeConfig("t", S, B, "train")
    whole = _on(scenario_batch(cfg, spec), spec)
    bspecs = shd.batch_spec(cfg, shape, mesh, whole)
    batch = {k: shd.shard_of(v, bspecs[k], mesh, mesh.rank)
             for k, v in whole.items()}
    step = trainer_lib.make_train_step(cfg, opt, mesh, specs, mspecs,
                                       batch_axes=shd.batch_axes(mesh, B))
    collectives.reset_stats(mesh)
    step(params, state, batch)
    out = collectives.stats(mesh)
    del out["seconds"]
    return out
