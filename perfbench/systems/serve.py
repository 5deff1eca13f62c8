"""A served model: the port's ``AsyncServer`` over its ``Server`` engine.

The configuration file gives the model's published sizes, its dtype,
the SparCE settings and the engine's (slots, cache, buckets); the
weights are made on the card from the seed. The load generator of the
cell's traffic kind drives ``submit`` and reads each token as its
client would. After the window, a sample of the finished requests is
held against the plain f32 reference: the widest gap by which a served
token's logit lies below the reference's best at that position.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from perfbench import harness, loadgen, weights, work
from perfbench.reference import llama

# The ServeMetrics counters the per-layer metrics read over the window.
COUNTERS = ("prefill_s", "prefill_tokens", "decode_s", "ticks",
            "decode_tokens", "skipped_tile_dots", "total_tile_dots",
            "admitted", "completed")

HF_TO_PORT = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings", "hidden_act": "mlp_act",
}


def arch_config(config: Dict[str, Any]):
    """The port's ArchConfig for a configuration file: the registry's
    entry with every published size of the file, its dtype, SparCE and
    remat settings."""
    from repro_torch.configs import get_config
    from repro_torch.core.sparse_ops import SparsityConfig
    over = {HF_TO_PORT[k]: v for k, v in config["model"].items()
            if k in HF_TO_PORT}
    over["dtype"] = config["dtype"]
    over["sparsity"] = SparsityConfig(**config.get("sparsity", {}))
    if "remat" in config:
        over["remat"] = config["remat"]
    return dataclasses.replace(get_config(config["arch"]), **over)


def make_weights(config: Dict[str, Any], seed: int, device):
    from repro_torch.models import model as model_lib
    meta = model_lib.init_params(arch_config(config), device="meta")
    return weights.make_params(meta, seed, device)


@dataclasses.dataclass
class Serve:
    cfg: Any  # the port's ArchConfig
    model: Dict[str, Any]  # the published sizes
    params: Dict[str, Any]
    srv: Any  # AsyncServer
    spans: Optional[harness.KernelSpans] = None
    hook: Optional["EngineHook"] = None

    def counters(self) -> Dict[str, float]:
        m = self.srv.metrics
        return {k: float(getattr(m, k)) for k in COUNTERS}

    def queue_depth(self) -> int:
        return self.srv.server.queue_depth()


def build(cell: harness.Cell, seed: int, device, trace: bool) -> Serve:
    """Weights on the card, the engine started, and every shape the
    traffic will use warmed (``warm``)."""
    import torch
    from repro_torch.runtime.server import AsyncServer, ServeConfig
    from repro_torch.core.sparse_ops import SparsityConfig
    config = cell.config
    cfg = arch_config(config)
    params = make_weights(config, seed, device)
    torch.cuda.synchronize()
    harness.log("weights made")
    eng = dict(config["engine"])
    buckets = eng.pop("prefill_buckets", None)
    sc = ServeConfig(
        **eng, prefill_buckets=None if buckets is None else tuple(buckets),
        sparsity=SparsityConfig(**config.get("sparsity", {})),
        seed=int(seed) % (1 << 32))
    srv = AsyncServer(cfg, params, sc, device=device)
    out = Serve(cfg, config["model"], params, srv)
    harness.log("engine started")
    if trace:
        out.spans = instrument(out)
    warm(out, config["engine"], cell.workload["params"])
    torch.cuda.synchronize()
    harness.log(f"warm: {out.counters()}")
    return out


def warm(serve: Serve, engine: Dict[str, Any], traffic: Dict[str, Any]
         ) -> None:
    """Prefill once in each bucket that the mix's prompts reach, at the
    longest of them there, each a few decode ticks."""
    from repro_torch.runtime.paging import pick_bucket, resolve_buckets
    buckets = resolve_buckets(engine.get("prefill_buckets"),
                              engine["max_len"])
    longest: Dict[int, int] = {}
    for row in loadgen.size_grid(traffic):
        for prompt, _ in row:
            b = pick_bucket(prompt, buckets)
            longest[b] = max(longest.get(b, 0), prompt)
    vocab = serve.model["vocab_size"]
    rng = np.random.default_rng(0)
    hs = [serve.srv.submit(rng.integers(0, vocab, n), max_new=4)
          for _, n in sorted(longest.items())]
    for h in hs:
        h.result(timeout=1200)
    serve.srv.drain(timeout=600)


class EngineHook:
    """Runs callables on the engine's own thread, before its next step,
    prefill or decode tick (so within one of them of the request), as
    the profiler's start and stop must (see ``harness.Profiled``)."""

    def __init__(self, srv):
        self._lock = threading.Lock()
        self._pending: List[tuple] = []
        eng = srv.server
        has_work = srv._work_pending

        def work_pending():
            return bool(self._pending) or has_work()

        srv._work_pending = work_pending
        for attr in ("step", "_prefill_one", "_decode_tick"):
            self._before(eng, attr, has_work if attr == "step" else None)

    def _before(self, obj, attr: str, gate) -> None:
        orig = getattr(obj, attr)

        def hooked(*args, **kwargs):
            self._run()
            if gate is not None and not gate():
                return {"admitted": 0, "decoded": 0}
            return orig(*args, **kwargs)

        setattr(obj, attr, hooked)

    def _run(self) -> None:
        with self._lock:
            todo, self._pending = self._pending, []
        for fn, done, box in todo:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - raised by call()
                box.append(e)
            done.set()

    def call(self, fn, timeout: float = 120.0) -> None:
        done, box = threading.Event(), []
        with self._lock:
            self._pending.append((fn, done, box))
        if not done.wait(timeout):
            raise RuntimeError("the engine thread did not take the call")
        if box:
            raise box[0]


def instrument(serve: Serve) -> harness.KernelSpans:
    """The traced run's spans: the paged GQA kernel's entry point with
    its work, the engine's phases for the idle breakdown, and the hook
    that starts and stops the profiler on the engine's thread."""
    from repro_torch.kernels import paged_decode_attn as pda
    spans = harness.KernelSpans()

    def gqa(args, kwargs, out):
        q, k_pool, _, tables, lengths = args[:5]
        B, KV, g, D = q.shape
        bs, elt = k_pool.shape[1], q.element_size()
        return lambda: work.paged_gqa(B, KV, g, D, bs,
                                      lengths.cpu().numpy(), elt)

    spans.wrap(pda, "paged_gqa_decode_attn", "paged_gqa", gqa)
    s = serve.srv.server
    for attr, label in (("_admission_phase", "admission"),
                        ("_prefill_one", "prefill"),
                        ("_decode_tick", "decode_tick"),
                        ("_sample", "sample"),
                        ("_grow_and_account", "grow_and_account")):
        spans.span(s, attr, label)
    serve.hook = EngineHook(serve.srv)
    return spans


def stop(serve: Serve) -> None:
    """Stop the engine now (requests still in flight fail) and free its
    caches; the weights stay for the reference."""
    import torch
    serve.srv.shutdown(drain=False, timeout=120)
    if serve.spans is not None:
        serve.spans.restore()
    serve.srv = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- the check
def sample(records: List[Any], seed: int, n: int) -> List[Any]:
    """``n`` finished requests drawn from the seed, the longest (prompt
    plus served tokens) always among them."""
    done = [r for r in records if r.finished and r.tokens]
    if not done:
        return []
    done.sort(key=lambda r: r.uid)
    longest = max(done, key=lambda r: (r.prompt_len + len(r.tokens), r.uid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 17])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def logit_gaps(params, model: Dict[str, Any], reqs: List[Any], device,
               fp8: bool = False) -> List[float]:
    """For each request, the widest gap over its served tokens between
    the reference's best logit and the served token's, at each position
    where the served token was predicted. With ``fp8`` the tokens are
    the ones the reference in float8 e4m3 puts first at those positions
    (the control: it need not decode)."""
    import torch
    seqs, rows = [], []
    for r in reqs:
        full = np.concatenate([r.prompt(), np.asarray(r.tokens[:-1],
                                                      np.int64)])
        seqs.append(torch.as_tensor(full, device=device))
        p = r.prompt_len
        rows.append(torch.arange(p - 1, p - 1 + len(r.tokens),
                                 device=device))
    ref = llama.logits_at(params, model, seqs, rows)
    if not fp8:
        picks = [torch.as_tensor(np.asarray(r.tokens, np.int64),
                                 device=device) for r in reqs]
    else:
        ctl = llama.logits_at(params, model, seqs, rows, fp8=True)
        picks = [c.argmax(-1) for c in ctl]
        del ctl
    gaps = []
    for z, t in zip(ref, picks):
        best = z.max(-1).values
        got = z.gather(-1, t[:, None].long())[:, 0]
        gaps.append(float((best - got).max()))
    return gaps


def check(serve: Serve, records: List[Any], seed: int, device,
          config: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """The served tokens of a sample of finished requests against the
    plain reference's logits (run after the engine has stopped)."""
    import sys
    lim = config["limits"]
    reqs = sample(records, seed, lim["sample_requests"])
    if not reqs:
        return {"max_logit_gap": {"value": float("inf"),
                                  "limit": lim["max_logit_gap"]}}
    t0 = time.perf_counter()
    gaps = logit_gaps(serve.params, serve.model, reqs, device)
    print(f"reference: {len(reqs)} requests, "
          f"{sum(len(r.tokens) for r in reqs)} served tokens, "
          f"{time.perf_counter() - t0:.1f} s; gaps {gaps}",
          file=sys.stderr, flush=True)
    return {"max_logit_gap": {"value": max(gaps),
                              "limit": lim["max_logit_gap"]}}


# ------------------------------------------------------------------ a run
def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, traffic, t_start: float) -> Dict[str, Any]:
    """Set-up, the window, then the check: what the metric readers and
    the result line need."""
    serve = build(cell, seed, device, trace)
    out = traffic.run(serve, cell, seed, seconds, trace, harness)
    setup_s = out["t_open"] - t_start
    for name, t, c in out["snaps"]:
        harness.log(f"window {name} at {t - out['t_open']:.3f}: {c}")
    slices = out.pop("profiled")
    if slices:
        harness.log("profiler stops (s): " + " ".join(
            f"{p.stop_s:.2f}" for p in slices))
    stop(serve)
    peak = max(out["peak_setup_bytes"], out["peak_window_bytes"])
    ctx: Dict[str, Any] = dict(out, setup_s=setup_s, model=serve.model,
                               config=cell.config,
                               workload_params=cell.workload["params"],
                               spans=serve.spans,
                               memory_peak_bytes=peak)
    if trace:
        ctx["trace"] = harness.read_trace(slices)
    # The traffic's own count where it keeps one; else the requests in
    # service or sent in the window, of which one that failed before
    # the close failed (those the engine's stop cut did not).
    recs, a, b = out["records"], out["t_open"], out["t_close"]
    tried = out.get("attempted")
    failed = out.get("failed")
    if tried is None:
        tried = [r for r in recs if r.sent < b and (
            not r.finished or r.t_end >= a)]
        failed = [r for r in tried if r.error is not None and r.t_end < b]
    ctx["attempted"], ctx["failed"] = len(tried), len(failed)
    # The check's sample: requests finished from the open on, through an
    # open loop's tail (a traced window's profiler stalls may leave none
    # of those due in it finished by the close).
    done = [r for r in recs if r.finished and r.t_end >= a]
    ctx["checks"] = check(serve, done, seed, device, cell.config)
    return ctx
