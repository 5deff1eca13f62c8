"""Seeded fault injection in the port: the injector's decisions, and
the engine's containment, against the reference on the CPU.

The port keeps its own copy of ``runtime/faults.py``; every decision it
makes must be the reference's bit for bit over a grid of (site, uid,
counter). Under each fault kind the port's engine must fail exactly the
requests the reference's fails (same error types), keep every survivor's
tokens those of a fault-free run, and end with the reference's pool. A
non-request-scoped error stays engine-fatal. Helpers:
``test_torch_live_engine.py``.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.runtime import faults as ref_faults
from repro.runtime import server as ref_server
from repro.runtime.errors import is_request_scoped as ref_is_request_scoped
from repro_torch.runtime import faults
from repro_torch.runtime import server as port_server
from repro_torch.runtime.errors import (
    EngineFatal, RequestFailed, is_request_scoped,
)
from serving_harness import Traffic, make_traffic
from test_torch_live_engine import (  # noqa: F401 - fixture
    assert_same_run, model, one_torch_thread, port_request, ref_request,
    serve_configs,
)

PLANS = (
    dict(seed=0, poison_rate=0.3, step_fault_rate=0.2,
         alloc_exhaust_rate=0.1, transient_alloc_rate=0.3),
    dict(seed=42, poison_rate=0.05, poison_uids=(2, 7),
         step_fault_rate=0.5, alloc_exhaust_rate=0.5,
         transient_alloc_rate=0.5, transient_fails=3, max_faults=12),
)


def _decisions(mod, plan):
    """Every decision of one injector over a grid of (site, uid,
    counter, attempt), in call order, with what it fired."""
    inj = mod.FaultInjector(mod.FaultPlan(**plan))
    out = []
    for uid in range(12):
        out.append(("poison", uid, inj.poison(uid)))
        for t in range(6):
            out.append(("step", uid, t, inj.step_fault_one(uid, t)))
        for g, a in itertools.product(range(4), range(4)):
            try:
                inj.alloc_gate(uid, g, a)
                out.append(("gate", uid, g, a, None))
            except mod.InjectedFault as e:
                out.append(("gate", uid, g, a, e.kind, e.transient))
    return out, inj.injected, list(inj.events), sorted(inj.failed_uids())


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_injector_decisions_equal_reference(plan):
    got = _decisions(faults, PLANS[plan])
    assert got == _decisions(ref_faults, PLANS[plan])
    assert got[1] > 0


def test_site_codes_and_poison_helper_equal_reference():
    assert faults._SITE_CODES == ref_faults._SITE_CODES
    for n, rate, seed in ((40, 0.2, 7), (10, 0.5, 0), (5, 0.0, 1)):
        assert faults.poison_uids_for(n, rate, seed) \
            == ref_faults.poison_uids_for(n, rate, seed)


def test_fault_plan_validation_like_reference():
    for bad in (dict(poison_rate=-0.1), dict(step_fault_rate=1.5),
                dict(transient_fails=0), dict(max_faults=-1)):
        with pytest.raises(ValueError) as got:
            faults.FaultPlan(**bad)
        with pytest.raises(ValueError) as want:
            ref_faults.FaultPlan(**bad)
        assert str(got.value) == str(want.value)
    assert faults.FaultPlan(poison_uids=[3, 1]).poison_uids \
        == frozenset({1, 3})


def test_is_request_scoped_like_reference():
    cases = [ValueError("bad shape"), FloatingPointError("nan"),
             RuntimeError("CUDA error: an illegal memory access"),
             EngineFatal("dead"), KeyboardInterrupt(), MemoryError()]
    for e in cases:
        assert is_request_scoped(e) == ref_is_request_scoped(e), e
    assert is_request_scoped(faults.InjectedFault("poison", 0))
    assert ref_is_request_scoped(ref_faults.InjectedFault("poison", 0))


# ------------------------------------------------------------- the sweep
KINDS = {
    "poison": dict(poison_rate=0.25),
    "step": dict(step_fault_rate=0.04),
    "exhaust": dict(alloc_exhaust_rate=0.12),
    "transient": dict(transient_alloc_rate=0.3),
    "transient-outlives": dict(transient_alloc_rate=0.3, transient_fails=5),
}
SEEDS = (0, 1, 2, 3, 4)


@pytest.fixture(scope="module")
def sweep():
    """One engine pair for the whole sweep (the plan swaps per run; the
    metrics of both accumulate over the same runs), and a fault-free
    port engine."""
    ref_cfg, cfg, ref_params, params = model()
    ref_sc, sc = serve_configs(batch_slots=2, max_len=64, kv_block_size=4)
    return (ref_cfg, ref_server.Server(ref_cfg, ref_params, ref_sc),
            port_server.Server(cfg, params, sc, device="cpu"),
            port_server.Server(cfg, params, sc, device="cpu"))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fault_sweep_matches_reference(kind, sweep):
    """Per seed: the faulted run of both engines decides the same
    (failed uids and types, survivors' tokens, every counter, the pool),
    the failed set is the injector's, and survivors keep the tokens of
    the fault-free run."""
    ref_cfg, ref_srv, srv, clean_srv = sweep
    fired = 0
    for seed in SEEDS:
        reqs = make_traffic(ref_cfg, Traffic(
            n_requests=6, prompt_lens=(2, 10), max_new=(2, 5), seed=seed))
        clean = {r.uid: r.out.tolist()
                 for r in clean_srv.generate([port_request(r) for r in reqs])}
        plan = dict(seed=seed, **KINDS[kind])
        ref_srv.sc = dataclasses.replace(
            ref_srv.sc, faults=ref_faults.FaultPlan(**plan))
        srv.sc = dataclasses.replace(srv.sc,
                                     faults=faults.FaultPlan(**plan))
        ref_srv.admitted_uids.clear()
        srv.admitted_uids.clear()
        ref_reqs = [ref_request(r) for r in reqs]
        ref_done = ref_srv.generate(ref_reqs)
        port_reqs = [port_request(r) for r in reqs]
        done = srv.generate(port_reqs)
        assert_same_run(ref_srv, ref_done, ref_reqs, srv, done, port_reqs)
        fired += srv._inj.injected
        assert len(done) + len(srv.failed) == 6
        # The failed set, from the seeded schedule: every non-transient
        # event fails its request, and a transient one too once it
        # outlives the engine's retries.
        fails = set(srv._inj.failed_uids())
        if kind == "transient-outlives":
            fails = {uid for _, uid in srv._inj.events}
        assert {r.uid for r in srv.failed} == fails
        for r in srv.failed:
            assert isinstance(r.error, RequestFailed)
            assert isinstance(r.error.__cause__, faults.InjectedFault)
        if kind == "transient":
            assert not srv.failed  # within the retry budget
        for r in done:
            assert r.out.tolist() == clean[r.uid], (kind, seed, r.uid)
    assert fired > 0, f"{kind}: no fault fired over seeds {SEEDS}"


def test_non_request_scoped_prefill_error_is_engine_fatal():
    """A RuntimeError out of a head's prefill (as a CUDA error would be)
    is not contained: it leaves ``step`` as is, while a ValueError of
    the same prefill fails that request only and the engine goes on."""
    _, cfg, _, params = model()
    srv = port_server.Server(cfg, params, port_server.ServeConfig(
        batch_slots=2, max_len=32, kv_block_size=4), device="cpu")
    real = srv._prefill_one
    bad = {}

    def prefill(r, *a):
        if r.uid in bad:
            raise bad[r.uid]
        return real(r, *a)

    srv._prefill_one = prefill
    reqs = [port_server.Request(uid=u, prompt=np.arange(1, 5) + u,
                                max_new=3) for u in range(3)]
    bad[1] = ValueError("prompt-shaped problem")
    done = srv.generate(reqs)
    assert [r.uid for r in done] == [0, 2]
    (failed,) = srv.failed
    assert isinstance(failed.error, RequestFailed)
    assert isinstance(failed.error.__cause__, ValueError)
    assert srv.metrics.faults_recovered == 0  # not an injected fault
    srv._st.alloc.check(expect_reserved=0)

    bad[1] = RuntimeError("CUDA error: an illegal memory access")
    srv.start_engine()
    for r in reqs:
        srv.enqueue(port_server.Request(uid=r.uid, prompt=r.prompt,
                                        max_new=3))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        while srv.queue_depth() or srv.any_active():
            srv.step()
