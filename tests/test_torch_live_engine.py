"""The port's live serving engine against the reference's, on the CPU.

The same reduced config and weights (carried over by the bridge) and the
same seeded open-loop traffic (``serving_harness.OpenLoopTraffic``) go
through the reference engine and the port's engine (``device="cpu"``,
plain kernel versions): ``serve_trace`` under the SLO scheduler, the
stepwise ``start_engine``/``enqueue``/``cancel``/``step`` surface and
``generate`` must give the same admission order, per-request tokens,
stats and error types, the same failed and shed requests, every
integer, skip, SLO, preemption, shed and fault metric, and the same
allocator and prefix-index state afterwards. The port's ``AsyncServer``
is driven on threads (daemon threads, a timeout on every wait) against
the reference's synchronous tokens. The helpers here are shared by
``test_torch_preemption.py`` and ``test_torch_faults.py``.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core.sparse_ops import SparsityConfig as RefSparsityConfig
from repro.models import model as ref_model
from repro.runtime import server as ref_server
from repro.runtime.faults import FaultPlan as RefFaultPlan
from repro.runtime.scheduler import SLOConfig as RefSLOConfig
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.runtime import server as port_server
from repro_torch.runtime.errors import (
    EngineFatal, RequestCancelled, RequestFailed, ServerOverloaded,
)
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.scheduler import SLOConfig
from serving_harness import (
    OpenLoopTraffic, Traffic, make_open_loop_trace, make_traffic,
)
from test_torch_server import EXACT_FIELDS

# The live engine's counters, on top of the drain engine's EXACT_FIELDS.
LIVE_FIELDS = (
    "preemptions", "requeues", "preempt_restore_ticks", "shed_requests",
    "cancelled", "failed_requests", "faults_injected", "faults_recovered",
    "slo_ttft_violations", "slo_itl_violations",
    "prefix_lookups", "prefix_hits", "prefix_matched_tokens",
    "prefix_blocks_shared", "prefix_cow_forks", "prefix_evicted_blocks",
    "prefix_cache_blocks",
)
# Request.stats read off the virtual clock (the rest is wall clock).
TICK_STATS = ("tokens", "decode_ticks", "queue_ticks", "ttft_ticks",
              "itl_ticks_max", "preemptions")
WAIT = 120  # seconds: a bound on every blocking call of a threaded test


# ------------------------------------------------------ shared helpers
def configs(arch="smollm-135m", act=None):
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if act is not None:
        ref_cfg = dataclasses.replace(ref_cfg, mlp_act=act)
        cfg = dataclasses.replace(cfg, mlp_act=act)
    return ref_cfg, cfg


def model(arch="smollm-135m", act=None, seed=0):
    """(ref_cfg, cfg, ref_params, params): the reference's weights and
    the same weights in the port (CPU)."""
    ref_cfg, cfg = configs(arch, act)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


def serve_configs(*, slo=None, faults=None, sparsity=None, **kw):
    """The same ServeConfig in the reference and in the port; ``slo``,
    ``faults`` and ``sparsity`` are dicts of their fields."""
    ref_sc = ref_server.ServeConfig(
        slo=None if slo is None else RefSLOConfig(**slo),
        faults=None if faults is None else RefFaultPlan(**faults),
        sparsity=None if sparsity is None else RefSparsityConfig(**sparsity),
        **kw)
    sc = port_server.ServeConfig(
        slo=None if slo is None else SLOConfig(**slo),
        faults=None if faults is None else FaultPlan(**faults),
        sparsity=None if sparsity is None else SparsityConfig(**sparsity),
        **kw)
    return ref_sc, sc


def ref_request(r, **kw):
    return ref_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                              max_new=r.max_new, eos_id=r.eos_id,
                              max_ticks=r.max_ticks, **kw)


def port_request(r):
    return port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                               max_new=r.max_new, eos_id=r.eos_id,
                               max_ticks=r.max_ticks)


def trace_pair(trace):
    """Fresh copies of an arrival trace for each engine."""
    return ([(a, ref_request(r)) for a, r in trace],
            [(a, port_request(r)) for a, r in trace])


def error_type(r):
    return None if r.error is None else type(r.error).__name__


def outcome(srv, done, requests):
    """Everything a run decides, keyed so the two engines compare: the
    admission and completion order, each request's tokens, tick stats
    and error type, the failed uids in failure order, the shed uids."""
    per_uid = {}
    for r in requests:
        per_uid[r.uid] = (
            None if r.out is None else np.asarray(r.out).tolist(),
            {k: r.stats[k] for k in TICK_STATS if k in r.stats},
            error_type(r))
    return dict(
        admitted=list(srv.admitted_uids),
        completed=[r.uid for r in done],
        failed=[(r.uid, error_type(r)) for r in srv.failed],
        shed=sorted(r.uid for r in requests
                    if error_type(r) == "ServerOverloaded"),
        per_uid=per_uid)


def pool_state(alloc, prefix):
    """The allocator's free list (in order), live blocks, references and
    reservation, and the prefix index's key -> block map."""
    return dict(
        free=list(alloc._free), allocated=sorted(alloc._allocated),
        refcount=dict(sorted(alloc._refcount.items())),
        reserved=alloc._reserved,
        index=None if prefix is None else dict(prefix._by_key))


def assert_same_run(ref_srv, ref_done, ref_reqs, srv, done, reqs):
    """The port's run equals the reference's in everything it decides,
    every exact and live metric, and the pool afterwards."""
    want = outcome(ref_srv, ref_done, ref_reqs)
    got = outcome(srv, done, reqs)
    for key in want:
        assert got[key] == want[key], key
    for name in EXACT_FIELDS + LIVE_FIELDS:
        assert getattr(srv.metrics, name) == getattr(ref_srv.metrics,
                                                     name), name
    assert pool_state(srv._st.alloc, srv._prefix) == pool_state(
        ref_srv._st.allocs[0], ref_srv._prefix)
    assert_clean(srv)


def assert_clean(srv):
    """Nothing live or reserved; only the prefix index holds blocks."""
    st = srv._st
    assert all(s is None for s in st.slots) and srv.queue_depth() == 0
    st.alloc.check(expect_reserved=0)
    held = 0 if srv._prefix is None else len(srv._prefix)
    assert st.alloc.in_use == held and st.alloc.reserved == 0


def serve_trace_both(m, trace, *, priorities=None, deadlines=None, **sc_kw):
    """``serve_trace`` of one trace through both engines; returns
    (ref_srv, ref_done, ref_reqs, srv, done, reqs)."""
    ref_cfg, cfg, ref_params, params = m
    ref_sc, sc = serve_configs(**sc_kw)
    ref_trace, port_trace = trace_pair(trace)
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_sc)
    ref_done = ref_srv.serve_trace(ref_trace, priorities=priorities,
                                   deadlines=deadlines)
    srv = port_server.Server(cfg, params, sc, device="cpu")
    done = srv.serve_trace(port_trace, priorities=priorities,
                           deadlines=deadlines)
    return (ref_srv, ref_done, [r for _, r in ref_trace],
            srv, done, [r for _, r in port_trace])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines' tensors are tiny: one intra-op thread keeps the
    port's CPU steps from paying a thread pool's wake-ups per op."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dense():
    return model()


# --------------------------------------------- serve_trace under the SLO
SLO_CASES = {
    # The reference's seeded SLO trace (test_scheduler.py).
    "seeded-slo": dict(
        traffic=OpenLoopTraffic(n_requests=8, prompt_lens=(2, 10),
                                max_new=(2, 8), seed=5, rate_per_tick=0.5),
        sc=dict(batch_slots=3, max_len=64,
                slo=dict(target_ttft_ticks=32.0, target_itl_ticks=3.0))),
    # Open-loop metrics under a looser SLO, 2 slots, small blocks.
    "open-loop-metrics": dict(
        traffic=OpenLoopTraffic(n_requests=6, prompt_lens=(2, 10),
                                max_new=(2, 6), seed=3, rate_per_tick=0.4),
        sc=dict(batch_slots=2, max_len=64, kv_block_size=8,
                slo=dict(target_ttft_ticks=32.0, target_itl_ticks=4.0))),
    # A pool too small for every slot's worst case: admission waits on
    # blocks; paged attention's plain version.
    "small-pool-paged": dict(
        traffic=OpenLoopTraffic(n_requests=7, prompt_lens=(4, 20),
                                max_new=(4, 12), seed=11,
                                rate_per_tick=0.6),
        sc=dict(batch_slots=3, max_len=48, kv_block_size=4,
                kv_pool_blocks=14, attn_kernel="paged",
                slo=dict(target_ttft_ticks=24.0, target_itl_ticks=2.0))),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_serve_trace_matches_reference(case, dense):
    c = SLO_CASES[case]
    trace = make_open_loop_trace(dense[0], c["traffic"])
    out = serve_trace_both(dense, trace, **c["sc"])
    assert_same_run(*out)
    srv, done = out[3], out[4]
    assert len(done) == c["traffic"].n_requests
    m = srv.metrics
    assert m.ttft_ticks_p99 >= m.ttft_ticks_p50 > 0
    assert abs(m.prefill_tick_share + m.decode_tick_share - 1.0) < 1e-9
    # The same trace on the same (reused) Server replays to the same
    # schedule: start_engine resets the virtual clock.
    first = outcome(srv, done, out[5])
    _, reqs = trace_pair(trace)
    n = len(srv.admitted_uids)
    again = outcome(srv, srv.serve_trace(reqs), [r for _, r in reqs])
    assert again.pop("admitted")[n:] == first.pop("admitted")
    assert again == first


@pytest.mark.parametrize("kernels", [
    # The GLU through the fused GLU kernel's plain version, attention
    # through the paged kernel's, the prefix cache on.
    dict(act=None, attn_kernel="paged", prefix_cache=True,
         sparsity=dict(enabled=True, mode="fused", gate_threshold=0.0,
                       autotune=False)),
    # The relu MLP (--sparce) through the relu-bitmap and gated GEMM
    # kernels' plain versions, per-slot tiles.
    dict(act="relu", attn_kernel="paged", prefix_cache=False,
         sparsity=dict(enabled=True, mode="kernel", block_m=1,
                       block_k=32)),
], ids=["glu-fused-prefix", "relu-kernel"])
def test_serve_trace_through_the_kernels_matches_reference(kernels):
    """The SLO engine over the kernels' plain versions with preemption,
    a bounded queue and a burst: the same schedule, tokens, skip
    counters and pool as the reference's."""
    kernels = dict(kernels)
    m = model(act=kernels.pop("act"))
    traffic = OpenLoopTraffic(n_requests=6, prompt_lens=(4, 24),
                              max_new=(3, 10), seed=7, rate_per_tick=1.0,
                              burst_at=4.0, burst_n=4)
    trace = make_open_loop_trace(m[0], traffic)
    urgent = {r.uid for _, r in trace if r.uid % 3 == 0}
    out = serve_trace_both(
        m, trace, priorities={u: 1.0 for u in urgent},
        deadlines={u: 1.0 for u in urgent}, batch_slots=3, max_len=64,
        kv_block_size=8, kv_pool_blocks=12, preempt=True, max_queue_depth=4,
        slo=dict(target_ttft_ticks=8.0, target_itl_ticks=2.0), **kernels)
    assert_same_run(*out)
    m = out[3].metrics
    assert 0 <= m.skipped_tile_dots < m.total_tile_dots
    assert m.preemptions > 0 and m.shed_requests > 0


def test_priority_overrides_fifo_like_reference(dense):
    """A high-priority late uid jumps the FIFO class (1 slot exposes the
    order)."""
    reqs = make_traffic(dense[0], Traffic(n_requests=4, prompt_lens=(4, 6),
                                          max_new=(6, 6), seed=2))
    out = serve_trace_both(dense, [(0.0, r) for r in reqs],
                           priorities={3: 10.0}, batch_slots=1, max_len=64)
    assert_same_run(*out)
    assert list(out[3].admitted_uids) == [3, 0, 1, 2]


def test_forced_ttft_under_tight_itl_like_reference(dense):
    """An ITL target too tight for voluntary admission: queued requests
    are admitted by the forced-TTFT clause, as in the reference."""
    ref_cfg = dense[0]
    rng = np.random.default_rng(0)
    long_req = ref_server.Request(
        uid=0, prompt=rng.integers(0, ref_cfg.vocab_size, 6), max_new=48)
    late = [ref_server.Request(
        uid=i, prompt=rng.integers(0, ref_cfg.vocab_size, 4), max_new=3)
        for i in range(1, 4)]
    trace = [(0.0, long_req)] + [(float(i), r)
                                 for i, r in enumerate(late, start=1)]
    out = serve_trace_both(
        dense, trace, batch_slots=4, max_len=96,
        slo=dict(target_ttft_ticks=24.0, target_itl_ticks=1.0))
    assert_same_run(*out)
    m = out[3].metrics
    assert m.sched_deferred > 0 and m.sched_forced >= 3
    by_uid = {r.uid: r for r in out[4]}
    for r in late:
        assert 24.0 / 3 <= by_uid[r.uid].stats["ttft_ticks"] <= 24.0 + 5.0


def test_generate_with_slo_matches_reference(dense):
    ref_cfg, cfg, ref_params, params = dense
    reqs = make_traffic(ref_cfg, Traffic(n_requests=5, prompt_lens=(2, 10),
                                         max_new=(2, 6), seed=9))
    ref_sc, sc = serve_configs(
        batch_slots=2, max_len=64,
        slo=dict(target_ttft_ticks=16.0, target_itl_ticks=2.0))
    ref_reqs = [ref_request(r) for r in reqs]
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_sc)
    ref_done = ref_srv.generate(ref_reqs)
    port_reqs = [port_request(r) for r in reqs]
    srv = port_server.Server(cfg, params, sc, device="cpu")
    done = srv.generate(port_reqs)
    assert_same_run(ref_srv, ref_done, ref_reqs, srv, done, port_reqs)
    assert srv.metrics.sched_deferred > 0


# ------------------------------------------------- the stepwise surface
def test_stepwise_cancel_matches_reference(dense):
    """start_engine/enqueue/step/cancel: a live and a queued request
    cancelled between steps, an unknown uid ignored, in both engines."""
    ref_cfg, cfg, ref_params, params = dense
    rng = np.random.default_rng(2)
    reqs = [ref_server.Request(uid=u, prompt=rng.integers(
        0, ref_cfg.vocab_size, 4), max_new=n)
        for u, n in ((0, 16), (1, 4), (2, 5))]
    ref_sc, sc = serve_configs(batch_slots=1, max_len=64, kv_block_size=8)
    runs = []
    for make, srv in (
            (ref_request, ref_server.Server(ref_cfg, ref_params, ref_sc)),
            (port_request, port_server.Server(cfg, params, sc,
                                              device="cpu"))):
        srv.start_engine()
        mine = [make(r) for r in reqs]
        for r in mine:
            srv.enqueue(r)
        srv.step()  # admits uid 0 (one slot); 1 and 2 stay queued
        assert srv.any_active() and srv.queue_depth() == 2
        for uid in (0, 1, 999):
            srv.cancel(uid)
        while srv.queue_depth() or srv.any_active():
            srv.step()
        srv.finalize_metrics()
        runs.append((srv, list(srv._st.completed), mine))
    assert_same_run(*runs[0], *runs[1])
    srv, done, mine = runs[1]
    failed = {r.uid: r for r in srv.failed}
    assert set(failed) == {0, 1} and [r.uid for r in done] == [2]
    assert all(isinstance(r.error, RequestCancelled) for r in failed.values())
    assert len(failed[0].out) >= 1 and len(failed[1].out) == 0
    assert srv.metrics.cancelled == 2


def test_max_ticks_deadline_matches_reference(dense):
    """A per-request decode budget frees the slot mid-flight with 1
    prefill token + max_ticks attached, as in the reference."""
    ref_cfg, cfg, ref_params, params = dense
    rng = np.random.default_rng(3)
    reqs = [ref_server.Request(uid=0, prompt=rng.integers(
                0, ref_cfg.vocab_size, 4), max_new=30, max_ticks=3),
            ref_server.Request(uid=1, prompt=rng.integers(
                0, ref_cfg.vocab_size, 4), max_new=5)]
    ref_sc, sc = serve_configs(batch_slots=2, max_len=64, kv_block_size=8)
    ref_reqs = [ref_request(r) for r in reqs]
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_sc)
    ref_done = ref_srv.generate(ref_reqs)
    port_reqs = [port_request(r) for r in reqs]
    srv = port_server.Server(cfg, params, sc, device="cpu")
    done = srv.generate(port_reqs)
    assert_same_run(ref_srv, ref_done, ref_reqs, srv, done, port_reqs)
    (failed,) = srv.failed
    assert failed.uid == 0 and isinstance(failed.error, RequestCancelled)
    assert len(failed.out) == 4


# ------------------------------------------------------- AsyncServer
def run_thread(fn, *args):
    """Run ``fn`` on a daemon thread; returns a join that re-raises."""
    box = {}

    def body():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - handed to join
            box["err"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()

    def join():
        t.join(timeout=WAIT)
        assert not t.is_alive(), "thread did not finish in time"
        if "err" in box:
            raise box["err"]
        return box.get("out")
    return join


def test_async_server_matches_reference_generate(dense):
    """Submitted before start, the live queue serves the FIFO schedule:
    tokens, admission order and counts equal the reference's
    ``generate``."""
    ref_cfg, cfg, ref_params, params = dense
    reqs = make_traffic(ref_cfg, Traffic(n_requests=6, prompt_lens=(2, 10),
                                         max_new=(2, 6), seed=21))
    ref_sc, sc = serve_configs(batch_slots=3, max_len=64)
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_sc)
    want = {r.uid: np.asarray(r.out).tolist()
            for r in ref_srv.generate([ref_request(r) for r in reqs])}
    asrv = port_server.AsyncServer(cfg, params, sc, device="cpu",
                                   start=False)
    handles = [asrv.submit(r.prompt, max_new=r.max_new, uid=r.uid)
               for r in reqs]
    asrv.start()
    done = asrv.drain(timeout=WAIT)
    asrv.shutdown(timeout=WAIT)
    assert {r.uid: r.out.tolist() for r in done} == want
    assert [h.result(timeout=WAIT).uid for h in handles] == sorted(want)
    assert list(asrv.server.admitted_uids) == list(ref_srv.admitted_uids)
    for name in ("completed", "ticks", "decode_tokens", "prefill_tokens"):
        assert getattr(asrv.metrics, name) == getattr(ref_srv.metrics, name)
    assert_clean(asrv.server)


def test_async_stream_equals_result(dense):
    _, cfg, _, params = dense
    with port_server.AsyncServer(
            cfg, params, port_server.ServeConfig(batch_slots=2, max_len=64),
            device="cpu") as asrv:
        h = asrv.submit(np.array([1, 2, 3]), max_new=5)
        streamed = [int(t) for t in asrv.stream(h, timeout=WAIT)]
        r = h.result(timeout=WAIT)
        assert h.done and streamed == r.out.tolist()
        assert r.stats["tokens"] == 5
    with pytest.raises(RuntimeError, match="shut down"):
        asrv.submit(np.array([1]), max_new=1)


def test_async_shutdown_abort_fails_outstanding_handles(dense):
    _, cfg, _, params = dense
    asrv = port_server.AsyncServer(
        cfg, params, port_server.ServeConfig(batch_slots=1, max_len=96),
        device="cpu")
    h = asrv.submit(np.array([1, 2, 3]), max_new=64)
    asrv.shutdown(drain=False, timeout=WAIT)
    assert not asrv._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        h.result(timeout=WAIT)


def test_async_submit_refuses_impossible_requests_up_front(dense):
    _, cfg, _, params = dense
    with port_server.AsyncServer(
            cfg, params, port_server.ServeConfig(batch_slots=1, max_len=16),
            device="cpu", start=False) as asrv:
        with pytest.raises(ValueError, match="do not fit"):
            asrv.submit(np.arange(40), max_new=4)
        with pytest.raises(ValueError, match="1-D"):
            asrv.submit(np.zeros((2, 3), np.int64), max_new=2)
        h = asrv.submit(np.array([1, 2]), max_new=2, uid=7)
        with pytest.raises(ValueError, match="already in flight"):
            asrv.submit(np.array([3, 4]), max_new=2, uid=7)
        assert h.result(timeout=WAIT).stats["tokens"] == 2


def test_async_cancel_shed_and_max_ticks(dense):
    """The reference's async robustness walk: a queued and a live cancel,
    a shed at the door, a finished handle that cannot be cancelled, a
    max_ticks deadline; the counts add up and the pool drains."""
    _, cfg, _, params = dense
    asrv = port_server.AsyncServer(cfg, params, port_server.ServeConfig(
        batch_slots=1, max_len=64, kv_block_size=8, max_queue_depth=2),
        device="cpu")
    h_long = asrv.submit(np.array([1, 2]), max_new=40)
    deadline = time.time() + WAIT
    while not asrv.server.any_active():
        assert time.time() < deadline, "engine never admitted"
        time.sleep(0.01)
    queued = [asrv.submit(np.array([1, 2, 3]), max_new=4) for _ in range(2)]
    with pytest.raises(ServerOverloaded):
        asrv.submit(np.array([1, 2, 3]), max_new=2)
    assert len(asrv._handles) == 3

    assert asrv.cancel(queued[1]) is True
    with pytest.raises(RequestCancelled, match="queued"):
        queued[1].result(timeout=WAIT)
    assert len(queued[1].request.out) == 0
    assert asrv.cancel(h_long) is True
    with pytest.raises(RequestCancelled):
        h_long.result(timeout=WAIT)
    assert len(h_long.request.out) >= 1

    assert queued[0].result(timeout=WAIT).stats["tokens"] == 4
    assert asrv.cancel(queued[0]) is False
    h_tick = asrv.submit(np.array([5, 6, 7]), max_new=30, max_ticks=5)
    with pytest.raises(RequestCancelled, match="max_ticks"):
        h_tick.result(timeout=WAIT)
    assert len(h_tick.request.out) == 6

    asrv.drain(timeout=WAIT)
    m = asrv.metrics
    assert m.shed_requests == 1 and m.cancelled == 3
    assert {r.uid for r in asrv.failed} == {h_long.uid, queued[1].uid,
                                            h_tick.uid}
    assert_clean(asrv.server)
    asrv.shutdown(timeout=WAIT)


def test_async_stream_survives_preemption(dense):
    """A low-priority stream preempted by an urgent submit: its streamed
    tokens still equal its result (a restore does not re-emit carried
    tokens), and equal an uninterrupted run's. The engine's steps are
    released one at a time until the urgent request is in."""
    _, cfg, _, params = dense
    sc = port_server.ServeConfig(
        batch_slots=1, max_len=64, kv_block_size=8, preempt=True,
        slo=SLOConfig(target_ttft_ticks=64.0, target_itl_ticks=2.0))
    prompt = np.arange(3, 9)
    solo = port_server.Server(cfg, params, sc, device="cpu").generate(
        [port_server.Request(uid=0, prompt=prompt, max_new=20)])[0]
    asrv = port_server.AsyncServer(cfg, params, sc, device="cpu",
                                   start=False)
    gate, step = threading.Semaphore(0), asrv._srv.step

    def gated_step():
        assert gate.acquire(timeout=WAIT)
        return step()

    asrv._srv.step = gated_step
    asrv.start()
    h = asrv.submit(prompt, max_new=20, uid=0)
    it = asrv.stream(h, timeout=WAIT)
    gate.release(4)  # the admission, then three decode ticks
    streamed = [int(next(it)) for _ in range(4)]
    urgent = asrv.submit(np.array([4, 5, 6]), max_new=3, uid=1,
                         priority=5.0, deadline_ticks=0.5)
    gate.release(10_000)
    streamed += [int(t) for t in it]
    assert urgent.result(timeout=WAIT).stats["tokens"] == 3
    assert streamed == h.result(timeout=WAIT).out.tolist() \
        == solo.out.tolist()
    asrv.drain(timeout=WAIT)
    assert asrv.metrics.preemptions == 1
    assert h.request.stats["preemptions"] == 1
    assert list(asrv.server.admitted_uids) == [0, 1, 0]
    assert_clean(asrv.server)
    asrv.shutdown(timeout=WAIT)


def test_shutdown_timeout_is_one_deadline_not_two(dense):
    """shutdown(timeout=t) returns within ~t even when the engine is in a
    long step: the join gets what the drain left."""
    _, cfg, _, params = dense
    asrv = port_server.AsyncServer(
        cfg, params, port_server.ServeConfig(batch_slots=1, max_len=32),
        device="cpu", start=False)
    asrv.submit(np.array([1, 2]), max_new=4)
    in_step = threading.Event()

    def sleepy_step():
        in_step.set()
        time.sleep(5.0)
        return {"admitted": 0, "decoded": 0}

    asrv._srv.step = sleepy_step
    asrv.start()
    assert in_step.wait(timeout=WAIT)
    t0 = time.perf_counter()
    asrv.shutdown(timeout=1.0)
    assert time.perf_counter() - t0 < 1.8


def test_engine_thread_error_is_fatal(dense):
    """A non-request-scoped error out of the engine's step fails every
    handle with EngineFatal chaining the cause; submits are refused."""
    _, cfg, _, params = dense
    asrv = port_server.AsyncServer(
        cfg, params, port_server.ServeConfig(batch_slots=1, max_len=32),
        device="cpu", start=False)
    h = asrv.submit(np.array([1, 2]), max_new=4)

    def doomed_step():
        raise RuntimeError("CUDA error: an illegal memory access")

    asrv._srv.step = doomed_step
    asrv.start()
    with pytest.raises(EngineFatal, match="engine thread died") as ei:
        h.result(timeout=WAIT)
    assert isinstance(ei.value.__cause__, RuntimeError)
    with pytest.raises(EngineFatal):
        asrv.drain(timeout=WAIT)
    with pytest.raises(RuntimeError, match="shut down"):
        asrv.submit(np.array([3]), max_new=1)
    asrv.shutdown(drain=False, timeout=WAIT)


def test_async_hammer_submit_cancel_shutdown(dense):
    """Three client threads submit and cancel against a bounded queue
    with step faults injected: every handle ends in exactly one typed
    outcome, the counts add up, the pool drains."""
    _, cfg, _, params = dense
    asrv = port_server.AsyncServer(cfg, params, port_server.ServeConfig(
        batch_slots=2, max_len=64, kv_block_size=8, max_queue_depth=16,
        faults=FaultPlan(seed=3, step_fault_rate=0.02)), device="cpu")
    handles, sheds, lock = [], [0], threading.Lock()

    def client(tid):
        rng = np.random.default_rng(tid)
        for _ in range(6):
            prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(2, 8)))
            try:
                h = asrv.submit(prompt, max_new=int(rng.integers(1, 5)))
            except ServerOverloaded:
                with lock:
                    sheds[0] += 1
                continue
            if rng.random() < 0.3:
                asrv.cancel(h)
            with lock:
                handles.append(h)

    joins = [run_thread(client, t) for t in range(3)]
    for j in joins:
        j()
    outcomes = {"done": 0, "cancelled": 0, "failed": 0}
    for h in handles:
        try:
            r = h.result(timeout=WAIT)
            assert len(r.out) == r.max_new
            outcomes["done"] += 1
        except RequestCancelled:
            outcomes["cancelled"] += 1
        except RequestFailed:
            outcomes["failed"] += 1
    asrv.drain(timeout=WAIT)
    m = asrv.metrics
    assert (outcomes["done"], outcomes["cancelled"], outcomes["failed"],
            sheds[0]) == (m.completed, m.cancelled, m.failed_requests,
                          m.shed_requests)
    assert sum(outcomes.values()) == len(handles) == 18 - sheds[0]
    assert_clean(asrv.server)
    asrv.shutdown(timeout=WAIT)
    assert not asrv._thread.is_alive()


def test_gqa_counter_first_fill_is_one_tensor_under_threads(monkeypatch):
    """Engine threads of two servers may launch the GQA kernel for a new
    (device, stream, shape) at once: every thread gets the same counter
    tensor, so no call waits on counters another call never zeroes. More
    threads than cores, a short switch interval."""
    import sys
    import torch
    from repro_torch.kernels import paged_decode_attn as pda
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(pda, "_GQA_COUNTS", {})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for trial in range(20):
            start, got = threading.Barrier(16), []

            def fill():
                start.wait(timeout=WAIT)
                got.append(pda._gqa_counts(torch.device("cpu"), 0, 8, trial))

            joins = [run_thread(fill) for _ in range(16)]
            for j in joins:
                j()
            assert len(got) == 16 and all(t is got[0] for t in got)
    finally:
        sys.setswitchinterval(interval)
    assert len(pda._GQA_COUNTS) == 20
