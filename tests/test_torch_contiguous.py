"""The port's serving engine on the contiguous KV layout
(``kv_block_size=0``) against the reference's.

Each case runs a ``--reduced`` config (f32, so greedy streams are
exact), with the reference's ``init_params`` weights carried over by the
bridge, through the reference's engine and the port's on seeded harness
traffic: tokens, completion and admission order and every non-wall
``ServeMetrics`` field must be equal. The contiguous engine must also
give the port's own paged engine's tokens and counters; a slot reused
after a longer request must give the cache-free oracle's tokens (every
cache leaf of the slot's row is overwritten at admission); the live
engine's ``serve_trace`` under an SLO, a bounded queue and a fault plan
(without allocator faults, whose site is paged-only) must schedule as
the reference's does; and the paths that need the paged layout are
refused with the reference's exception types.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.runtime import server as ref_server
from repro_torch.configs import get_config
from repro_torch.models import model as port_model
from repro_torch.runtime import server as port_server
from serving_harness import (
    OpenLoopTraffic, Traffic, make_open_loop_trace, make_traffic,
)
from test_torch_live_engine import (
    LIVE_FIELDS, model, outcome, serve_configs, trace_pair,
)
from test_torch_server import EXACT_FIELDS

# Counters the layout does not change: the contiguous engine's equal the
# paged engine's on the same traffic.
LAYOUT_FREE = ("skipped_tile_dots", "total_tile_dots",
               "prefill_skipped_tile_dots", "prefill_total_tile_dots",
               "ticks", "decode_tokens", "prefill_tokens", "admitted",
               "completed")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def generate(srv, reqs, make):
    return srv.generate([make(uid=r.uid, prompt=np.asarray(r.prompt),
                              max_new=r.max_new, eos_id=r.eos_id)
                         for r in reqs])


def tokens(done):
    return {r.uid: np.asarray(r.out).tolist() for r in done}


@pytest.mark.parametrize("case", [
    # The gated GLU through the fused GLU kernel's plain version.
    dict(arch="smollm-135m", act=None, sparsity=dict(
        enabled=True, mode="fused", gate_threshold=0.0, autotune=False)),
    # The relu MLP (--sparce) through the fused relu MLP's plain version,
    # per-slot tiles: dead slots skip.
    dict(arch="smollm-135m", act="relu", sparsity=dict(
        enabled=True, mode="fused", block_m=1, block_k=32)),
    # The relu-bitmap and gated GEMM kernels' plain versions.
    dict(arch="smollm-135m", act="relu", sparsity=dict(
        enabled=True, mode="kernel", block_m=1, block_k=32)),
    # MLA and MoE, exact-length prefill.
    dict(arch="deepseek-v3-671b", act=None, sparsity=None),
], ids=["glu-fused", "relu-fused", "relu-kernel", "deepseek"])
def test_generate_matches_reference_and_paged_engine(case):
    ref_cfg, cfg, ref_params, params = model(case["arch"], case["act"])
    reqs = make_traffic(ref_cfg, Traffic(n_requests=6, prompt_lens=(2, 14),
                                         max_new=(1, 8), seed=4,
                                         eos_prob=0.3))
    kw = dict(batch_slots=3, max_len=32, sparsity=case["sparsity"])
    ref_sc, sc = serve_configs(kv_block_size=0, **kw)
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_sc)
    ref_done = generate(ref_srv, reqs, ref_server.Request)
    srv = port_server.Server(cfg, params, sc, device="cpu")
    done = generate(srv, reqs, port_server.Request)
    assert tokens(done) == tokens(ref_done)
    assert [r.uid for r in done] == [r.uid for r in ref_done]
    assert list(srv.admitted_uids) == list(ref_srv.admitted_uids)
    for name in EXACT_FIELDS:
        assert getattr(srv.metrics, name) == getattr(ref_srv.metrics,
                                                     name), name
    assert srv.metrics.kv_paged == 0 and srv.metrics.kv_block_size == 0
    assert srv._st.alloc is None and srv._st.tables is None
    if case["act"] == "relu":
        assert srv.metrics.skipped_tile_dots > 0  # dead slots skip
    _, paged_sc = serve_configs(kv_block_size=8, **kw)
    paged = port_server.Server(cfg, params, paged_sc, device="cpu")
    assert tokens(generate(paged, reqs, port_server.Request)) == \
        tokens(done)
    for name in LAYOUT_FREE:
        assert getattr(paged.metrics, name) == getattr(srv.metrics,
                                                       name), name


def oracle(params, cfg, prompt, max_new):
    """Greedy rollout over the port's cache-free full forward."""
    toks = list(np.asarray(prompt).tolist())
    out = []
    with torch.no_grad():
        for _ in range(max_new):
            logits, _, _ = port_model.forward(
                params, cfg, {"tokens": torch.tensor([toks])})
            out.append(int(logits[0, -1].argmax()))
            toks.append(out[-1])
    return out


@pytest.mark.parametrize("arch,fields", [
    ("smollm-135m", {}),
    # One chunk covers every oracle sequence (the scan's length rule).
    ("mamba2-2.7b", dict(chunk=64)),
    ("zamba2-7b", dict(chunk=64)),
])
def test_slot_reused_after_longer_request(arch, fields):
    """Two slots: a long prompt fills slot 0 and finishes first while
    slot 1 serves on; the next request reuses slot 0 over the longer
    request's rows, conv window and state. Every request gives the
    cache-free oracle's tokens."""
    cfg = get_config(arch).reduced()
    if fields:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, **fields))
    params = port_model.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(6)
    shape = [(20, 3), (2, 12), (3, 6)]  # (prompt, max_new) per uid
    reqs = [port_server.Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, n), max_new=m) for i, (n, m) in enumerate(shape)]
    srv = port_server.Server(cfg, params, port_server.ServeConfig(
        batch_slots=2, max_len=48, kv_block_size=0), device="cpu")
    done = srv.generate(reqs)
    assert list(srv.admitted_uids) == [0, 1, 2]
    assert [r.uid for r in done] == [0, 2, 1]  # uid 2 ran in slot 0
    for r in done:
        assert r.out.tolist() == oracle(params, cfg, r.prompt, r.max_new)


def test_serve_trace_matches_reference():
    """The live engine on contiguous caches: an SLO, a bounded queue
    that sheds, poisoned prompts and step faults (the fault sites of
    this layout). Schedules, tokens, errors and every exact and live
    metric equal the reference's."""
    m = model()
    traffic = OpenLoopTraffic(n_requests=8, prompt_lens=(2, 12),
                              max_new=(2, 8), seed=9, rate_per_tick=1.0,
                              burst_at=3.0, burst_n=4)
    trace = make_open_loop_trace(m[0], traffic)
    ref_cfg, cfg, ref_params, params = m
    ref_sc, sc = serve_configs(
        batch_slots=3, max_len=32, kv_block_size=0, max_queue_depth=3,
        slo=dict(target_ttft_ticks=8.0, target_itl_ticks=2.0),
        faults=dict(seed=2, poison_uids=frozenset({1, 9}),
                    step_fault_rate=0.05))
    ref_trace, port_trace = trace_pair(trace)
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_sc)
    ref_done = ref_srv.serve_trace(ref_trace)
    srv = port_server.Server(cfg, params, sc, device="cpu")
    done = srv.serve_trace(port_trace)
    want = outcome(ref_srv, ref_done, [r for _, r in ref_trace])
    got = outcome(srv, done, [r for _, r in port_trace])
    for key in want:
        assert got[key] == want[key], key
    for name in EXACT_FIELDS + LIVE_FIELDS:
        assert getattr(srv.metrics, name) == getattr(ref_srv.metrics,
                                                     name), name
    mt = srv.metrics
    assert mt.shed_requests > 0 and mt.faults_injected > 0
    assert mt.failed_requests > 0 and mt.sched_deferred > 0
    assert all(s is None for s in srv._st.slots)


@pytest.mark.parametrize("arch,kw,where", [
    ("smollm-135m", dict(kv_block_size=0, attn_kernel="paged"), "config"),
    ("smollm-135m", dict(kv_block_size=0, prefix_cache=True), "config"),
    ("smollm-135m", dict(kv_block_size=0, preempt=True), "config"),
    ("mamba2-2.7b", dict(attn_kernel="paged"), "server"),
    ("zamba2-7b", dict(attn_kernel="paged"), "server"),
    ("mamba2-2.7b", dict(prefix_cache=True), "server"),
    ("zamba2-7b", dict(preempt=True), "server"),
])
def test_paged_only_paths_are_refused_like_reference(arch, kw, where):
    """The paged kernel, the prefix cache and preemption need the paged
    layout: without it ``ServeConfig`` refuses them; the ssm and hybrid
    families fall back to contiguous caches whatever the block size, so
    ``Server`` refuses them there. Same exception types and messages."""
    errors = []
    for mod, cfg in ((ref_server, ref_get_config(arch).reduced()),
                     (port_server, get_config(arch).reduced())):
        with pytest.raises(ValueError) as e:
            sc = mod.ServeConfig(**kw)
            assert where == "server"
            mod.Server(cfg, None, sc, **(
                {} if mod is ref_server else {"device": "cpu"}))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
