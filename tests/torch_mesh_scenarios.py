"""Serving scenarios for the port's mesh tests, run the same way on one
host and on rank 0 of a spawned (data, model) mesh.

Spawned ranks import this module by its name in a fresh interpreter, so
it imports neither jax nor the reference package. A scenario is a dict:

    name, act (MLP activation or None), cfg (config fields to replace),
    seed (weights), device (default "cpu"),
    sc (ServeConfig fields; sparsity/slo as dicts of their fields),
    driver ("generate" | "serve_trace" | "async"; the async driver
    serves the requests again after ``idle_s`` seconds idle when given),
    requests (port Requests) or trace ([(arrival_vt, Request)]),
    priorities, deadlines (serve_trace; uid -> value).

:func:`run_scenario` returns what a run decides: tokens by uid, every
metric, the admission order and the failed uids. Ranks record a digest
of every decode tick's logits (:func:`rank_main`), so a test can hold the
model ranks of one data group to bitwise-equal logits.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.models import model as model_lib
from repro_torch.parallel import worker
from repro_torch.runtime import server as port_server
from repro_torch.runtime.scheduler import SLOConfig

WAIT = 120  # seconds: a bound on every blocking call of the async driver


def scenario_model(act=None, seed=0, device="cpu", **fields):
    cfg = get_config("smollm-135m").reduced()
    if act is not None:
        cfg = dataclasses.replace(cfg, mlp_act=act)
    cfg = dataclasses.replace(cfg, **fields)
    return cfg, model_lib.init_params(cfg, seed=seed, device=device)


def serve_config(sc: dict, mesh=None) -> port_server.ServeConfig:
    kw = dict(sc)
    if kw.get("sparsity") is not None:
        kw["sparsity"] = SparsityConfig(**kw["sparsity"])
    if kw.get("slo") is not None:
        kw["slo"] = SLOConfig(**kw["slo"])
    return port_server.ServeConfig(mesh=mesh, **kw)


def _fresh(r):
    return port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                               max_new=r.max_new, eos_id=r.eos_id,
                               max_ticks=r.max_ticks)


def run_scenario(spec: dict, mesh=None) -> dict:
    """Serve one scenario on this host (``mesh`` None) or, on rank 0 of a
    running mesh, on ``mesh=(dp, tp)``."""
    device = spec.get("device", "cpu")
    cfg, params = scenario_model(spec.get("act"), spec.get("seed", 0),
                                 device, **spec.get("cfg", {}))
    sc = serve_config(spec["sc"], mesh)
    driver = spec.get("driver", "generate")
    if driver == "async":
        asrv = port_server.AsyncServer(cfg, params, sc, device=device,
                                       start=False)
        reqs = [_fresh(r) for r in spec["requests"]]
        handles = [asrv.submit(r.prompt, max_new=r.max_new, uid=r.uid,
                               eos_id=r.eos_id) for r in reqs]
        asrv.start()
        done = asrv.drain(timeout=WAIT)
        streamed = [h.result(timeout=WAIT).uid for h in handles]
        again = None
        if spec.get("idle_s"):
            # Idle, then serve the same requests again.
            time.sleep(spec["idle_s"])
            hs = [asrv.submit(r.prompt, max_new=r.max_new, uid=r.uid,
                              eos_id=r.eos_id) for r in reqs]
            again = {h.uid: h.result(timeout=WAIT).out.tolist() for h in hs}
        asrv.shutdown(timeout=WAIT)
        srv = asrv.server
    else:
        srv = port_server.Server(cfg, params, sc, device=device)
        if driver == "serve_trace":
            trace = [(a, _fresh(r)) for a, r in spec["trace"]]
            done = srv.serve_trace(trace, priorities=spec.get("priorities"),
                                   deadlines=spec.get("deadlines"))
        else:
            done = srv.generate([_fresh(r) for r in spec["requests"]])
        streamed = again = None
    st = srv._st
    return dict(
        name=spec["name"],
        tokens={r.uid: np.asarray(r.out).tolist() for r in done},
        metrics=dataclasses.asdict(srv.metrics),
        admitted=list(srv.admitted_uids),
        failed=[r.uid for r in srv.failed],
        streamed=streamed,
        again=again,
        pool_clean=all(a.reserved == 0 for a in st.allocs) and sum(
            a.in_use for a in st.allocs) == (
                0 if srv._prefixes is None
                else sum(len(p) for p in srv._prefixes)),
        shards=len(st.allocs),
    )


def run_scenarios(specs, mesh_shape):
    return [run_scenario(s, mesh_shape) for s in specs]


def rank_main(mesh, specs, fail_rank=None):
    """A spawned rank: rank 0 serves ``specs`` on the mesh, the others
    run the worker loop. Every rank records a digest of each decode
    tick's logits. ``fail_rank`` makes that rank's first decode raise
    (a worker failing mid-run)."""
    digests = []
    real = worker.run_decode

    def recorded(*a, **kw):
        if mesh.rank == fail_rank:
            raise RuntimeError(f"injected failure on rank {mesh.rank}")
        last, skip, caches = real(*a, **kw)
        digests.append(hashlib.sha1(
            last.detach().cpu().numpy().tobytes()).hexdigest())
        return last, skip, caches

    worker.run_decode = recorded
    shape = (mesh.shape["data"], mesh.shape["model"])
    out = worker.serve_rank(mesh, run_scenarios, (specs, shape),
                            device=specs[0].get("device", "cpu"))
    return dict(coords=mesh.coords(), digests=digests, out=out)
