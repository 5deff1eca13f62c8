"""Fault-tolerant single-host training loop.

Port of ``repro/runtime/trainer.py``:

  * a train step is ``loss_fn`` (model.py), ``loss.backward()`` through
    the SparCE ops' autograd rules (``core/sparse_ops.py``), then
    ``AdamW.update``;
  * checkpoint/restart: periodic atomic checkpoints of (params, optimizer
    state), restore-on-start, and in-loop recovery -- a ``RuntimeError``
    in a step (a lost device, a failed launch) restores the last
    checkpoint and goes on from it when ``ckpt_dir`` is set, and is
    re-raised otherwise;
  * straggler detection: a rolling window of step times flags a step
    slower than ``straggler_factor`` x the window's median.

The batches come from the caller's iterator as numpy arrays and are
moved to the trainer's device.

On a mesh (``Trainer(mesh=...)``, one process per rank; see
``launch/mesh.py``) every rank draws the same global batch and keeps its
rows (``sharding.batch_spec``), stores its slices of the params
(``sharding.param_specs``) and of the moments (``opt_state_shardings``,
cut over 'data' too under ``zero1``), and runs the sharded step: the
single-host model code inside the ambient mesh and its plan
(``sharding.TrainPlan``), each gradient averaged over the batch axes in
its dtype (one all-reduce per dtype over a flat buffer), then the
sharded update. Checkpoints are gathered whole and written by rank 0 in
the single-host format; a restore cuts any mesh's slices from them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.modules import iter_leaves, tree_map
from repro_torch.optim.adamw import (
    AdamState, AdamW, Shard, host_step, opt_state_shardings,
)
from repro_torch.parallel import sharding as shd


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    async_ckpt: bool = True
    straggler_window: int = 20
    straggler_factor: float = 3.0
    zero1: bool = False
    seed: int = 0


def make_train_step(cfg: ArchConfig, optimizer: AdamW, mesh=None,
                    specs=None, moment_specs=None, *, batch_axes=None
                    ) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss and its gradient with respect to every param leaf
    (zeros for a leaf the loss does not reach, as the reference's), then
    one optimizer update. ``batch`` holds tensors on the params' device.

    With ``mesh`` the trees hold this rank's slices (``specs``: the
    params' :func:`~repro_torch.parallel.sharding.param_specs` tree;
    ``moment_specs``: the moments' specs, a list in leaf order) and
    ``batch`` this rank's rows, cut over ``batch_axes`` (None: the batch
    is whole on every rank). The metrics are the global batch's, plus
    ``skip``: the MLPs' [skipped, total] tile dots over the mesh."""
    if mesh is None:
        return _single_step(cfg, optimizer)
    pspecs = list(shd.iter_leaves_specs(specs))
    shard = Shard(mesh, pspecs, list(moment_specs or pspecs))

    def train_step(params, opt_state, batch):
        leaves = list(iter_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        plan = shd.TrainPlan(mesh, cfg, specs, params, batch_axes)
        with shd.use_plan(plan):
            total, metrics, aux = model_lib.loss_terms(params, cfg, batch)
            total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
        if plan.batch_size > 1:
            grads = average_grads(grads, plan.batch_axes, mesh)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, stats = optimizer.update(grads, opt_state, params,
                                                    shard)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skip"] = _mesh_skip(aux["skip"].detach(), plan, cfg)
        return params, opt_state, {**metrics, **stats}

    return train_step


def _single_step(cfg: ArchConfig, optimizer: AdamW) -> Callable:
    def train_step(params, opt_state, batch):
        for p in iter_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        total, metrics = model_lib.loss_fn(params, cfg, batch)
        total.backward()
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        for p in iter_leaves(params):
            p.grad = None
            p.requires_grad_(False)
        params, opt_state, stats = optimizer.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **stats}

    return train_step


def init_moments(params, moment_specs: list, mesh) -> AdamState:
    """A fresh AdamW state holding this rank's slices of the moments of
    the full ``params`` (f32 zeros of each ``moment_specs`` block)."""
    specs = iter(moment_specs)
    shapes = [shd.shard_shape(p.shape, next(specs), mesh)
              for p in iter_leaves(params)]

    def zeros():
        it = iter(shapes)
        return tree_map(lambda p: torch.zeros(
            next(it), dtype=torch.float32, device=p.device), params)
    return AdamState(host_step(), zeros(), zeros())


def average_grads(grads: List[torch.Tensor], axes, mesh
                  ) -> List[torch.Tensor]:
    """Each gradient averaged over ``axes`` in its dtype: one all-reduce
    per dtype over a flat buffer of that dtype's gradients."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    n = mesh.group_size(axes)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        collectives.psum(flat, axes, mesh)
        flat = flat / n
        off = 0
        for i in idx:
            k = grads[i].numel()
            out[i] = flat[off:off + k].view_as(grads[i])
            off += k
    return out


def _mesh_skip(skip: torch.Tensor, plan, cfg: ArchConfig) -> torch.Tensor:
    """The MLPs' skip counters over the mesh: summed over the batch
    axes, and over 'model' where the MLPs are tensor-parallel (each
    shard gates its own stripes)."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    axes = plan.batch_axes + (("model",) if plan.mlp_tp(cfg) else ())
    if not axes:
        return skip
    return collectives.psum(skip.clone(), axes, plan.mesh)


class Trainer:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 optimizer: AdamW, train_cfg: TrainConfig, mesh=None, *,
                 device="cuda"):
        """``mesh``: this rank's :class:`~repro_torch.parallel.sharding.
        Mesh` on an initialized world (``launch/mesh.py``), or None for
        one device. ``train_cfg.zero1`` cuts the moments over 'data'
        (a mesh without a 'data' axis keeps them whole, as the
        reference's rule does)."""
        self.cfg, self.shape, self.opt, self.tc = (cfg, shape, optimizer,
                                                   train_cfg)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.specs = self.moment_specs = None
        self.step_fn = (make_train_step(cfg, optimizer) if mesh is None
                        else None)  # a mesh's step needs the specs
        self.straggler_events: List[Dict] = []
        self._times: List[float] = []
        self._ckpt_thread = None

    # ------------------------------------------------------------- state
    def init_state(self, seed: int):
        """Seeded params and a fresh optimizer state; on a mesh this
        rank's slices of them (every rank draws the whole params, cuts
        them, and allocates only its slices of the moments) and the
        sharded step, for a global batch of ``shape.global_batch`` rows
        cut as ``sharding.batch_spec`` cuts it."""
        params = model_lib.init_params(self.cfg, seed=seed,
                                       device=self.device)
        if self.mesh is None:
            return params, self.opt.init(params)
        local, self.specs = shd.train_shard_params(params, self.mesh)
        self.moment_specs = list(shd.iter_leaves_specs(opt_state_shardings(
            AdamState((), params, params), self.specs, self.mesh,
            zero1=self.tc.zero1).mu))
        self.step_fn = make_train_step(
            self.cfg, self.opt, self.mesh, self.specs, self.moment_specs,
            batch_axes=shd.batch_axes(self.mesh, self.shape.global_batch))
        return local, init_moments(params, self.moment_specs, self.mesh)

    def state_specs(self) -> list:
        """One spec per leaf of (params, opt_state), in leaf order."""
        p = list(shd.iter_leaves_specs(self.specs))
        return p + [()] + self.moment_specs + self.moment_specs

    def restore_or_init(self, seed: int):
        if self._ckpt_thread is not None:
            # An async save still writing would be missed (or half read).
            self._ckpt_thread.join()
        if self.mesh is not None:
            self._barrier()  # rank 0's save is on disk for every rank
        params, opt_state = self.init_state(seed)
        start = 0
        if self.tc.ckpt_dir and ckpt.latest_step(self.tc.ckpt_dir) is not None:
            shard = (None if self.mesh is None
                     else (self.mesh, self.state_specs()))
            (params, opt_state), start, _ = ckpt.restore(
                self.tc.ckpt_dir, (params, opt_state), device=self.device,
                shard=shard)
            opt_state = opt_state._replace(
                step=host_step(int(opt_state.step)))
        return params, opt_state, start

    def _barrier(self) -> None:
        import torch.distributed as dist  # noqa: PLC0415

        dist.barrier(group=self.mesh.control)

    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """The batch on the trainer's device; on a mesh this rank's rows
        of the global batch, by ``sharding.batch_spec``."""
        out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        if self.mesh is not None:
            bspecs = shd.batch_spec(self.cfg, self.shape, self.mesh, out)
            out = {k: shd.shard_of(v, bspecs[k], self.mesh, self.mesh.rank)
                   for k, v in out.items()}
        return {k: v.to(self.device) for k, v in out.items()}

    # ------------------------------------------------------ fault hooks
    def _check_straggler(self, step: int, dt: float):
        self._times.append(dt)
        w = self._times[-self.tc.straggler_window:]
        if len(w) >= 5:
            med = float(np.median(w))
            if dt > self.tc.straggler_factor * med:
                self.straggler_events.append(
                    {"step": step, "dt": dt, "median": med})

    def _maybe_checkpoint(self, step: int, params, opt_state, *, force=False):
        if not self.tc.ckpt_dir:
            return
        if force or (step > 0 and step % self.tc.ckpt_every == 0):
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()
            shard = (None if self.mesh is None
                     else (self.mesh, self.state_specs()))
            self._ckpt_thread = ckpt.save(
                self.tc.ckpt_dir, step, (params, opt_state),
                async_=self.tc.async_ckpt, shard=shard)
            if self.mesh is None or self.mesh.rank == 0:
                ckpt.cleanup(self.tc.ckpt_dir, self.tc.keep_ckpts)

    # ---------------------------------------------------------------- run
    def run(self, data_iter: Iterator[Dict[str, np.ndarray]], *,
            fault_hook: Optional[Callable[[int], None]] = None,
            metrics_cb: Optional[Callable[[int, Dict], None]] = None,
            ) -> Dict[str, Any]:
        """Train to ``steps``. Returns params, optimizer state, the
        history (a record every ``log_every`` steps and one per restart),
        the straggler events and the final step. ``fault_hook(step)``,
        called before each step, may raise to simulate a failure."""
        params, opt_state, start = self.restore_or_init(self.tc.seed)
        history = []
        step = start
        while step < self.tc.steps:
            batch = self.to_device(next(data_iter))
            t0 = time.perf_counter()
            try:
                if fault_hook is not None:
                    fault_hook(step)
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                loss = float(metrics["loss"])  # synchronises
            except RuntimeError as e:
                # A failed step: restore the last checkpoint and go on.
                if not self.tc.ckpt_dir:
                    raise
                params, opt_state, step = self.restore_or_init(self.tc.seed)
                history.append({"event": "restart", "error": str(e)[:200]})
                continue
            dt = time.perf_counter() - t0
            self._check_straggler(step, dt)
            if metrics_cb:
                metrics_cb(step, metrics)
            if step % self.tc.log_every == 0:
                history.append({"step": step, "loss": loss, "dt": dt})
            step += 1
            self._maybe_checkpoint(step, params, opt_state)
        self._maybe_checkpoint(step, params, opt_state, force=True)
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        return {
            "params": params, "opt_state": opt_state, "history": history,
            "straggler_events": self.straggler_events, "final_step": step,
        }
