"""The device side of the serving engine, on one host or one mesh rank.

:class:`ShardEngine` holds what the engine keeps on a device -- the
params, the KV caches (the paged pool or the contiguous slot caches)
and the config they run under -- and runs every device action of the
engine: reset, a fresh prefill, a suffix prefill, a copy-on-write block
copy, a decode tick and a replan. ``runtime/server.py``'s :class:`Server`
keeps all host state (queue, scheduler, allocators, prefix indexes,
tables) and calls these actions through :meth:`ShardEngine.call`.

On one host the engine is the whole pool and the whole model. On a
(data, model) serving mesh there is ONE controller: rank 0 holds the
``Server`` and its host state for every shard -- the reference's
single-controller model -- and every device action is a command that
rank 0 broadcasts (with its host arrays) on the mesh's CPU control group
before running it on its own shard, (data 0, model 0). Every other rank
runs :func:`serve_worker`, which executes the commands on its shard:

* ``decode``: each data group runs its ``b_local`` slots against its own
  sub-pool (with its own null block 0) and its LOCAL block tables, on
  1/tp of the heads and FFN columns (``sharding.serve_local_config``:
  attention and the MLP close their row-sharded out-projections with one
  psum over 'model'). The logits are then equal over 'model'; model
  column 0 gathers them over 'data' to rank 0. The skip counters are
  summed over every rank.
* ``prefill`` / ``suffix``: only the owner slot's data group runs them,
  writing only its own sub-pool; their skip counters are summed over
  'model'. The owner group's model-0 rank sends the logits and counters
  to rank 0 when rank 0 is not in that group. (The reference replicates
  prefill over 'data'; the counters come out the same.)
* ``copy``: the owner group copies a pool block (local ids).
* ``reset`` / ``replan``: every rank.

Per-shard skip state, as the paper's per-core SpRF/SASA: a block past a
slot's length in the shard's own sub-pool, or a dead stripe of the
shard's own columns, is never loaded.

A worker that raises exits (``launch/mesh.py`` reports it), which fails
rank 0's pending collective on the closed connection, or after the
groups' timeout; rank 0 then raises out of the engine. Between commands
rank 0's controller sends a keepalive every quarter timeout, so an idle
engine does not time its workers out.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.models import modules as nn
from repro_torch.parallel.sharding import (
    Mesh, serve_local_config, shard_params, tree_map_with_path,
)

# The engine's device actions, the names of the commands a worker runs.
COMMANDS = ("reset", "prefill", "suffix", "copy", "decode", "replan")


# --------------------------------------------------------- device bodies
def run_prefill(params, cfg: ArchConfig, caches, toks: np.ndarray,
                rows0: int, scratch_rows: int, slot: int,
                block_ids: Optional[np.ndarray], device, paged: bool):
    """Prefill one padded prompt (batch of one) and put it in ``slot``:
    the paged layout scatters the scratch's rows into the pool blocks
    ``block_ids`` (int64 (max_blocks,), 0-padded), the contiguous one
    overwrites the slot's row of every cache leaf. Bucketable families
    advance by the TRUE rows ``rows0``; a vlm prompt runs behind zero
    patch embeddings. Returns (last-position logits f32, skip f32[2],
    caches)."""
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.family in model_lib.bucketable_families():
        # Exact-length families never pad: their prefill advances by S
        # implicitly, and forward rejects 'advance' for them.
        batch["advance"] = torch.tensor([rows0], dtype=torch.int32,
                                        device=device)
    if cfg.frontend == "patches":
        batch["patch_embeds"] = torch.zeros(
            (1, cfg.num_patches, cfg.d_model),
            dtype=nn.torch_dtype(cfg.dtype), device=device)
    small = model_lib.init_caches(cfg, 1, scratch_rows, device=device)
    with torch.no_grad():
        logits, small, aux = model_lib.forward(params, cfg, batch, small,
                                               last_only=True)
    if paged:
        caches = model_lib.insert_slot_paged(
            caches, small, slot, torch.from_numpy(block_ids).to(device),
            rows0)
    else:
        caches = model_lib.insert_slot_caches(caches, small, slot)
    return logits[0, 0].float(), aux["skip"], caches


def run_suffix(params, cfg: ArchConfig, caches, toks: np.ndarray,
               n_suffix: int, table_row: np.ndarray, prefix_len: int,
               rows0: int, ext_rows: int, slot: int, device):
    """Continuation prefill of a suffix behind ``prefix_len`` rows
    already in the pool blocks of ``table_row``: the prefix gathered into
    a scratch of ``ext_rows`` rows, the suffix run with
    ``continuation=True``, only its rows scattered back. Returns (logits
    f32, skip f32[2], caches)."""
    batch = {"tokens": torch.from_numpy(toks).to(device),
             "advance": torch.tensor([n_suffix], dtype=torch.int32,
                                     device=device)}
    ids = torch.from_numpy(np.asarray(table_row, np.int64)).to(device)
    small = model_lib.paged_prefix_caches(caches, ids, prefix_len, ext_rows)
    with torch.no_grad():
        logits, small, aux = model_lib.forward(
            params, cfg, batch, small, last_only=True, continuation=True)
    caches = model_lib.insert_slot_paged_from(caches, small, slot, ids,
                                              rows0, prefix_len)
    return logits[0, 0].float(), aux["skip"], caches


def run_decode(params, cfg: ArchConfig, caches, step: np.ndarray,
               active: np.ndarray, tables: Optional[np.ndarray],
               attn_kernel: str, device):
    """One decode tick of every slot in ``step`` (dead slots masked by
    ``active``). Returns (last logits f32 (B, V) or (B, K, V), skip
    f32[2], caches)."""
    with torch.no_grad():
        logits, caches, skip = model_lib.serving_decode_step(
            params, cfg, torch.from_numpy(step[..., None]).to(device),
            caches, torch.from_numpy(active).to(device),
            None if tables is None else torch.from_numpy(tables).to(device),
            attn_kernel=attn_kernel)
        last = (logits[:, 0] if cfg.frontend == "codes"
                else logits[:, -1]).float()
    return last, skip, caches


# ------------------------------------------------------------- the engine
class ShardEngine:
    """One device's part of the serving engine (see the module docstring).

    ``batch_slots`` and ``pool_blocks`` are the WHOLE engine's; on a mesh
    this rank serves ``batch_slots / dp`` slots over a sub-pool of
    ``pool_blocks / dp`` usable blocks plus its own null block 0. Slot
    indices and block ids in the commands are the engine's (global slot,
    shard-local block ids). Results come back on rank 0 (and on a single
    host); other ranks return None."""

    def __init__(self, cfg: ArchConfig, params, sc, device, *, paged: bool,
                 pool_blocks: int, max_rows: int, ext_rows: int,
                 mesh: Optional[Mesh] = None):
        self.cfg, self.sc, self.device, self.mesh = cfg, sc, device, mesh
        self.paged, self.max_rows, self.ext_rows = paged, max_rows, ext_rows
        if mesh is None:
            dp, tp, self.data, self.model = 1, 1, 0, 0
            self.params = params
        else:
            dp, tp = mesh.shape["data"], mesh.shape["model"]
            self.data, self.model = mesh.coord("data"), mesh.coord("model")
            self.params = shard_params(params, mesh)
        self.dp, self.tp = dp, tp
        self.b_local = sc.batch_slots // dp
        self.pool_shard = pool_blocks // dp
        self.cfg_l = self._local(cfg)
        self.caches = None
        self.controller: Optional[Controller] = (
            mesh.controller if mesh is not None and mesh.rank == 0 else None)

    def _local(self, cfg: ArchConfig) -> ArchConfig:
        return cfg if self.mesh is None else serve_local_config(cfg, self.tp)

    @property
    def leader(self) -> bool:
        """True where results come back: one host, or rank 0."""
        return self.mesh is None or self.mesh.rank == 0

    def call(self, cmd: str, **kw):
        """Run device action ``cmd``: on rank 0 of a mesh, broadcast it to
        the workers first."""
        if cmd not in COMMANDS:
            raise ValueError(f"unknown engine command {cmd!r}")
        if self.controller is not None:
            self.controller.send(cmd, kw)
        return getattr(self, cmd)(**kw)

    # Device actions -----------------------------------------------------
    def reset(self) -> None:
        """Fresh caches: this shard's sub-pool (its null block included)
        or the contiguous slot caches."""
        if self.paged:
            self.caches = model_lib.init_paged_caches(
                self.cfg_l, self.b_local, self.pool_shard + 1,
                self.sc.kv_block_size, device=self.device)
        else:
            self.caches = model_lib.init_caches(
                self.cfg_l, self.b_local, self.max_rows, device=self.device)

    def replan(self, expected_sparsity: float) -> None:
        sp = self.cfg.sparsity
        self.cfg = dataclasses.replace(self.cfg, sparsity=dataclasses.replace(
            sp, expected_sparsity=expected_sparsity))
        self.cfg_l = self._local(self.cfg)

    def _owned(self, slot: int, run):
        """Run ``run(local slot)`` -> (logits, skip, caches) on ``slot``'s
        owner data group, sum its skip counters over 'model', and return
        (logits, skip) as numpy on rank 0 (or the single host): local
        when rank 0 ran it, else sent by the owner group's model-0 rank.
        None elsewhere."""
        owner = slot // self.b_local
        last = skip = None
        if self.data == owner:
            last, skip, self.caches = run(slot - owner * self.b_local)
            skip = self._psum(skip, "model")
        if owner == 0:
            if not self.leader:
                return None
            return last.cpu().numpy(), skip.double().cpu().numpy()
        from repro_torch.parallel import collectives  # noqa: PLC0415
        cfg = self.cfg
        shape = ((cfg.num_codebooks, cfg.vocab_size)
                 if cfg.frontend == "codes" else (cfg.vocab_size,))
        n = int(np.prod(shape))
        if self.data == owner and self.model == 0:
            collectives.send(torch.cat([last.reshape(-1), skip.float()]),
                             dst=0)
        if not self.leader:
            return None
        buf = collectives.recv(torch.empty(n + 2, dtype=torch.float32,
                                           device=self.device),
                               src=self.mesh.rank_at(data=owner))
        return (buf[:n].reshape(shape).cpu().numpy(),
                buf[n:].double().cpu().numpy())

    def prefill(self, slot: int, toks: np.ndarray, rows0: int,
                scratch_rows: int, block_ids: Optional[np.ndarray]):
        """Admission prefill of ``slot`` (see :func:`run_prefill`)."""
        return self._owned(slot, lambda local: run_prefill(
            self.params, self.cfg_l, self.caches, toks, rows0, scratch_rows,
            local, block_ids, self.device, self.paged))

    def suffix(self, slot: int, toks: np.ndarray, n_suffix: int,
               table_row: np.ndarray, prefix_len: int, rows0: int):
        """Suffix prefill of ``slot`` (see :func:`run_suffix`)."""
        return self._owned(slot, lambda local: run_suffix(
            self.params, self.cfg_l, self.caches, toks, n_suffix, table_row,
            prefix_len, rows0, self.ext_rows, local, self.device))

    def copy(self, slot: int, dst: int, src: int) -> None:
        """Copy-on-write: pool block ``src`` into ``dst`` (local ids) in
        ``slot``'s owner group."""
        if self.data == slot // self.b_local:
            self.caches = model_lib.copy_pool_block(self.caches, dst, src)

    def decode(self, step: np.ndarray, active: np.ndarray,
               tables: Optional[np.ndarray]):
        """One decode tick: (B, ...) logits and the summed skip counters
        as numpy on the leader."""
        rows = slice(self.data * self.b_local, (self.data + 1) * self.b_local)
        last, skip, self.caches = run_decode(
            self.params, self.cfg_l, self.caches, step[rows], active[rows],
            None if tables is None else tables[rows], self.sc.attn_kernel,
            self.device)
        if self.mesh is not None:
            from repro_torch.parallel import collectives  # noqa: PLC0415
            skip = collectives.psum(skip, ("data", "model"))
            if self.model == 0:
                last = collectives.all_gather(last, "data")
        if not self.leader:
            return None
        return last.cpu().numpy(), skip.double().cpu().numpy()

    def _psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        if self.mesh is None:
            return x
        from repro_torch.parallel import collectives  # noqa: PLC0415
        return collectives.psum(x, axes)


# ----------------------------------------------------- the command channel
class Controller:
    """Rank 0's end of a serving mesh's command channel: broadcasts each
    command on the mesh's CPU control group (one sender at a time), and
    a keepalive when no command went out for a quarter of the groups'
    timeout."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._every = mesh.timeout_s / 4.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._keepalive,
                                        name="mesh-keepalive", daemon=True)
        self._thread.start()

    def send(self, cmd: str, kw: Optional[Dict[str, Any]] = None) -> None:
        from repro_torch.parallel import collectives  # noqa: PLC0415

        with self._lock:
            collectives.broadcast_object((cmd, kw or {}), src=0,
                                         mesh=self.mesh)
            self._last = time.monotonic()

    def _keepalive(self) -> None:
        while not self._stop.wait(self._every / 4.0):
            if time.monotonic() - self._last < self._every:
                continue
            try:
                self.send("ping")
            except RuntimeError:
                return  # the channel broke: the engine's next call raises

    def close(self) -> None:
        """Tell the workers to exit and stop the keepalive."""
        self._stop.set()
        self._thread.join(timeout=self.mesh.timeout_s)
        self.send("exit")


def _controller(mesh: Mesh) -> Controller:
    if mesh.controller is None:
        mesh.controller = Controller(mesh)
    return mesh.controller


def _meta(params):
    return tree_map_with_path(lambda p, x: x.to("meta"), params)


def open_engine(mesh: Mesh, cfg: ArchConfig, params, sc, device, **layout
                ) -> ShardEngine:
    """Rank 0: start a serving engine on the mesh -- the workers get the
    config, the engine layout and the full params (broadcast from rank 0,
    leaf by leaf), and every rank keeps its shard."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    if mesh.rank != 0:
        raise RuntimeError("the serving mesh's Server runs on rank 0; the "
                           "other ranks run parallel/worker.serve_worker")
    _controller(mesh).send("open", dict(cfg=cfg, sc=sc, layout=layout,
                                        meta=_meta(params)))
    tree_map_with_path(lambda p, x: collectives.broadcast(x, src=0), params)
    return ShardEngine(cfg, params, sc, device, mesh=mesh, **layout)


def serve_worker(mesh: Mesh, device) -> List[Dict[str, Any]]:
    """A worker rank's loop: run rank 0's commands on this rank's shard
    until ``exit``. Returns, per engine opened in turn, this rank's
    kernel launches and collectives' counters while it served (from the
    end of its params' broadcast)."""
    from repro_torch.parallel import collectives  # noqa: PLC0415

    device = torch.device(device)
    engine: Optional[ShardEngine] = None
    served: List[Dict[str, Any]] = []

    def close():
        if engine is not None:
            served.append({"launches": kernel_launches(),
                           "collectives": collectives.stats(mesh)})

    while True:
        cmd, kw = collectives.broadcast_object(None, src=0, mesh=mesh)
        if cmd == "exit":
            break
        if cmd == "ping":
            continue
        if cmd == "open":
            close()
            params = tree_map_with_path(
                lambda p, m: collectives.broadcast(
                    torch.empty(m.shape, dtype=m.dtype, device=device),
                    src=0),
                kw["meta"])
            engine = ShardEngine(kw["cfg"], params, kw["sc"], device,
                                 mesh=mesh, **kw["layout"])
            del params
            reset_launches()
            collectives.reset_stats(mesh)
            continue
        if cmd not in COMMANDS or engine is None:
            raise RuntimeError(f"worker rank {mesh.rank}: command {cmd!r} "
                               "without an open engine")
        getattr(engine, cmd)(**kw)
    close()
    return served


def stop_workers(mesh: Mesh) -> None:
    """Rank 0: end the workers' loops (idempotent)."""
    if mesh.controller is not None:
        ctl, mesh.controller = mesh.controller, None
        ctl.close()


def serve_rank(mesh: Mesh, driver, args: tuple = (), device="cuda"):
    """The entry a serving mesh's ranks run under ``launch/mesh.py:
    spawn_mesh``: rank 0 runs ``driver(*args)`` (which builds and drives
    its ``Server``) and then stops the workers; every other rank serves
    commands. Returns the driver's result on rank 0, the worker's
    per-engine counters (:func:`serve_worker`) elsewhere."""
    if mesh.rank != 0:
        return serve_worker(mesh, device)
    try:
        return driver(*args)
    finally:
        try:
            stop_workers(mesh)
        except RuntimeError:
            pass  # a worker already died; rank 0 reports the first error


def _wrappers():
    from repro_torch.kernels import (  # noqa: PLC0415
        paged_decode_attn, relu_bitmap, sparce_gemm, sparce_glu_mlp,
        sparce_mlp,
    )
    return (paged_decode_attn.paged_gqa_decode_attn,
            paged_decode_attn.paged_mla_decode_attn,
            sparce_glu_mlp.sparce_glu_mlp_fused, sparce_mlp.sparce_mlp_fused,
            relu_bitmap.relu_bitmap, relu_bitmap.relu_bwd_bitmap,
            sparce_gemm.sparce_gemm_gated, sparce_gemm.sparce_gemm_gated_both,
            sparce_gemm.sparce_gemm_compacted)


def kernel_launches() -> Dict[str, int]:
    """This process's launch count of every kernel wrapper."""
    return {f.__name__: int(f.launches) for f in _wrappers()}


def reset_launches() -> None:
    for f in _wrappers():
        f.launches = 0
