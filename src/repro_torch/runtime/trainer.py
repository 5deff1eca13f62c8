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
moved to the trainer's device. The reference's mesh (sharded params,
ZeRO-1 moments, elastic restore) waits for the multi-device port: a
``mesh`` or ``zero1`` raises NotImplementedError.
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
from repro_torch.optim.adamw import AdamW


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


def make_train_step(cfg: ArchConfig, optimizer: AdamW) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss and its gradient with respect to every param leaf
    (zeros for a leaf the loss does not reach, as the reference's), then
    one optimizer update. ``batch`` holds tensors on the params' device."""
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


class Trainer:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 optimizer: AdamW, train_cfg: TrainConfig, mesh=None, *,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer: mesh (sharded training) not ported yet; the port "
                "trains on one device")
        if train_cfg.zero1:
            raise NotImplementedError(
                "Trainer: zero1 (sharded optimizer state) not ported yet; "
                "it needs the multi-device port")
        self.cfg, self.shape, self.opt, self.tc = (cfg, shape, optimizer,
                                                   train_cfg)
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, optimizer)
        self.straggler_events: List[Dict] = []
        self._times: List[float] = []
        self._ckpt_thread = None

    # ------------------------------------------------------------- state
    def init_state(self, seed: int):
        params = model_lib.init_params(self.cfg, seed=seed,
                                       device=self.device)
        return params, self.opt.init(params)

    def restore_or_init(self, seed: int):
        if self._ckpt_thread is not None:
            # An async save still writing would be missed (or half read).
            self._ckpt_thread.join()
        params, opt_state = self.init_state(seed)
        start = 0
        if self.tc.ckpt_dir and ckpt.latest_step(self.tc.ckpt_dir) is not None:
            (params, opt_state), start, _ = ckpt.restore(
                self.tc.ckpt_dir, (params, opt_state), device=self.device)
        return params, opt_state, start

    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

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
            self._ckpt_thread = ckpt.save(
                self.tc.ckpt_dir, step, (params, opt_state),
                async_=self.tc.async_ckpt)
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
