"""Preempt/requeue, load shedding and the moe family in the port's live
engine, against the reference's engine on the CPU.

A preempted request restores from prompt ++ produced (suffix-only when
the prefix cache kept its written blocks) and must finish with the
tokens of an uninterrupted run; the reclaim policy, the shed policy and
every counter they move must decide as the reference's do on the same
seeded trace. Helpers: ``test_torch_live_engine.py``.
"""
import numpy as np
import pytest

from repro.runtime import server as ref_server
from repro_torch.runtime import server as port_server
from repro_torch.runtime.errors import ServerOverloaded
from serving_harness import OpenLoopTraffic, make_open_loop_trace
from test_torch_live_engine import (  # noqa: F401 - fixture
    assert_same_run, model, one_torch_thread, outcome, serve_trace_both,
    trace_pair,
)

SLO = dict(target_ttft_ticks=64.0, target_itl_ticks=2.0)


@pytest.fixture(scope="module")
def dense():
    return model()


def _preempt_scenario(cfg, seed=0, victim_new=24):
    """A long low-priority victim, then an urgent arrival with a tight
    TTFT deadline onto a 1-slot engine: admitting it needs an eviction."""
    rng = np.random.default_rng(seed)
    victim = ref_server.Request(
        uid=0, prompt=rng.integers(0, cfg.vocab_size, 6), max_new=victim_new)
    urgent = ref_server.Request(
        uid=1, prompt=rng.integers(0, cfg.vocab_size, 4), max_new=4)
    return [(0.0, victim), (3.0, urgent)], {1: 5.0}, {1: 6.0}


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preempted_rollout_matches_reference(prefix_cache, dense):
    """The victim is admitted, evicted and restored: the same schedule,
    tokens and pool as the reference's, and its tokens equal an
    uninterrupted run's; with the prefix cache the restore is a hit."""
    ref_cfg, cfg, _, params = dense
    trace, prios, deadlines = _preempt_scenario(ref_cfg)
    kw = dict(batch_slots=1, max_len=64, kv_block_size=8,
              prefix_cache=prefix_cache, preempt=True, slo=SLO)
    out = serve_trace_both(dense, trace, priorities=prios,
                           deadlines=deadlines, **kw)
    assert_same_run(*out)
    srv, done = out[3], out[4]
    m = srv.metrics
    assert m.preemptions >= 1 and m.requeues == m.preemptions
    assert m.preempt_restore_ticks > 0
    assert list(srv.admitted_uids).count(0) >= 2 and not srv.failed
    by_uid = {r.uid: r for r in done}
    assert by_uid[0].stats["preemptions"] >= 1
    if prefix_cache:
        assert m.prefix_hits >= 1
    # Uninterrupted: each request alone on the same engine config.
    for _, r in trace:
        alone = port_server.Server(cfg, params, port_server.ServeConfig(
            batch_slots=1, max_len=64, kv_block_size=8), device="cpu")
        (solo,) = alone.generate([port_server.Request(
            uid=r.uid, prompt=np.asarray(r.prompt), max_new=r.max_new)])
        assert by_uid[r.uid].out.tolist() == solo.out.tolist()


@pytest.mark.parametrize("case", ["no-flag", "peer"])
def test_no_preemption_like_reference(case, dense):
    """Without ``preempt`` the forced head waits; among peers (equal
    priority) nothing is evicted either. Both as in the reference."""
    ref_cfg = dense[0]
    if case == "no-flag":
        trace, prios, deadlines = _preempt_scenario(ref_cfg)
        kw = dict(preempt=False)
    else:
        trace, _, _ = _preempt_scenario(ref_cfg, seed=1, victim_new=12)
        trace = [(0.0, trace[0][1]), (0.5, trace[1][1])]
        trace[1][1].max_new = 2
        prios, deadlines, kw = None, {1: 1.0}, dict(preempt=True)
    out = serve_trace_both(dense, trace, priorities=prios,
                           deadlines=deadlines, batch_slots=1, max_len=64,
                           kv_block_size=8, slo=SLO, **kw)
    assert_same_run(*out)
    assert out[3].metrics.preemptions == 0
    assert list(out[3].admitted_uids) == [0, 1]


def test_block_pressure_reclaim_like_reference(dense):
    """Free slots but too few pool blocks for the urgent head: the
    block-pressure form of reclaim evicts a victim for its blocks."""
    ref_cfg = dense[0]
    rng = np.random.default_rng(4)
    low = [ref_server.Request(uid=u, prompt=rng.integers(
        0, ref_cfg.vocab_size, 14), max_new=18) for u in (0, 1)]
    urgent = ref_server.Request(
        uid=2, prompt=rng.integers(0, ref_cfg.vocab_size, 20), max_new=6)
    trace = [(0.0, low[0]), (0.0, low[1]), (4.0, urgent)]
    out = serve_trace_both(
        dense, trace, priorities={2: 3.0}, deadlines={2: 2.0},
        batch_slots=3, max_len=64, kv_block_size=4, kv_pool_blocks=16,
        preempt=True, slo=SLO)
    assert_same_run(*out)
    srv = out[3]
    assert srv.metrics.preemptions >= 1
    assert any(s is None for s in srv._st.slots)  # slots were never short


@pytest.mark.parametrize("depth", [2, 3])
def test_burst_sheds_like_reference(depth, dense):
    """An overload burst against a bounded queue sheds the reference's
    subset (typed errors, ``out == []``), the survivors complete, and a
    replay sheds the same uids."""
    t = OpenLoopTraffic(n_requests=4, prompt_lens=(2, 6), max_new=(2, 4),
                        seed=5, rate_per_tick=0.2, burst_at=2.0, burst_n=6)
    trace = make_open_loop_trace(dense[0], t)
    kw = dict(batch_slots=2, max_len=64, kv_block_size=8,
              max_queue_depth=depth,
              slo=dict(target_ttft_ticks=32.0, target_itl_ticks=4.0))
    out = serve_trace_both(dense, trace, **kw)
    assert_same_run(*out)
    srv, done, reqs = out[3], out[4], out[5]
    shed = [r for r in reqs if isinstance(r.error, ServerOverloaded)]
    assert srv.metrics.shed_requests == len(shed) >= 1
    assert all(len(r.out) == 0 for r in shed)
    assert len(done) == t.total_requests - len(shed)
    _, again = trace_pair(trace)
    srv2 = port_server.Server(dense[1], dense[3], srv.sc, device="cpu")
    first = outcome(srv, done, reqs)
    assert outcome(srv2, srv2.serve_trace(again),
                   [r for _, r in again]) == first


def test_deepseek_slo_and_preempt_like_reference():
    """The moe family (MLA attention, MoE layers, exact-length prefill)
    under the SLO with preemption and a bounded queue: the reference's
    schedule, tokens and pool."""
    m = model("deepseek-v3-671b")
    t = OpenLoopTraffic(n_requests=5, prompt_lens=(3, 12), max_new=(3, 9),
                        seed=3, rate_per_tick=1.0, burst_at=3.0, burst_n=3)
    trace = make_open_loop_trace(m[0], t)
    urgent = {r.uid for _, r in trace if r.uid % 3 == 1}
    out = serve_trace_both(
        m, trace, priorities={u: 1.0 for u in urgent},
        deadlines={u: 1.0 for u in urgent}, batch_slots=2, max_len=48,
        kv_block_size=4, kv_pool_blocks=10, attn_kernel="paged",
        preempt=True, max_queue_depth=3,
        slo=dict(target_ttft_ticks=8.0, target_itl_ticks=2.0))
    assert_same_run(*out)
    m = out[3].metrics
    assert m.preemptions > 0 and m.preempt_restore_ticks > 0


def test_live_engine_mix_like_reference(dense):
    """Everything at once, the CPU-sized counterpart of the chip's phase
    9 trace: Poisson arrivals and a burst, a shared prefix, priorities,
    max_ticks, a bounded queue, preemption and every fault kind."""
    ref_cfg = dense[0]
    t = OpenLoopTraffic(n_requests=10, prompt_lens=(4, 20), max_new=(3, 10),
                        seed=13, rate_per_tick=1.5, burst_at=6.0, burst_n=5)
    trace = make_open_loop_trace(ref_cfg, t)
    prefix = np.random.default_rng(99).integers(0, ref_cfg.vocab_size, 16)
    for _, r in trace[::2]:
        r.prompt = np.concatenate([prefix, r.prompt])
    for _, r in trace[1::4]:
        r.max_ticks = 2
    urgent = {r.uid for _, r in trace if r.uid % 4 == 0}
    out = serve_trace_both(
        dense, trace, priorities={u: 1.0 for u in urgent},
        deadlines={u: 2.0 for u in urgent}, batch_slots=3, max_len=64,
        kv_block_size=8, kv_pool_blocks=14, attn_kernel="paged",
        prefix_cache=True, preempt=True, max_queue_depth=5,
        slo=dict(target_ttft_ticks=12.0, target_itl_ticks=2.0),
        faults=dict(seed=0, step_fault_rate=0.02, alloc_exhaust_rate=0.05,
                    transient_alloc_rate=0.2, transient_fails=2,
                    poison_uids={3}))
    assert_same_run(*out)
    srv, done, reqs = out[3], out[4], out[5]
    m = srv.metrics
    counted = ({r.uid for r in done} | {r.uid for r in srv.failed}
               | {r.uid for r in reqs if r.error is not None})
    assert sorted(counted) == sorted(r.uid for r in reqs)
    assert len(done) + len(srv.failed) + m.shed_requests == len(reqs)
    for name in ("preemptions", "shed_requests", "faults_injected",
                 "cancelled", "failed_requests", "prefix_hits"):
        assert getattr(m, name) > 0, name
