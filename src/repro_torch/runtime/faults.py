"""Seeded, deterministic fault injection for the serving engine.

The port's own copy of ``repro/runtime/faults.py`` (numpy only): the
site codes and the seed derivation are the reference's, so every
decision equals the reference's on the same plan.

A :class:`FaultPlan` describes WHICH faults to inject at WHAT rates; a
:class:`FaultInjector` (one per engine run, built in ``start_engine``)
turns the plan into concrete fire/no-fire decisions at the engine's
injection sites. Every decision is a pure function of
``(plan.seed, site, request uid, per-request progress counter)`` --
counter-based keys, never wall time or call order -- so the same
workload under the same plan injects the same faults on every host and
every rerun. That determinism is what lets the fault-sweep tests assert
*exactly which* requests fail.

Injection sites (all inside ``runtime/server.py``):

* ``poison``  -- consulted once per admission, before the prefill runs:
  a poisoned prompt raises out of the prefill path and the engine must
  contain it to that request (roll back its blocks/commitment, fail its
  submission, keep serving).
* ``step``    -- consulted per live slot per decode tick: a
  request-scoped step fault (host-side bookkeeping for one slot blew
  up) fails that slot only.
* ``exhaust`` -- consulted at lazy block growth: an injected allocator
  exhaustion for this request's next block. Non-retryable; the engine
  fails the request and releases its resources.
* ``transient`` -- also at block growth: the first
  ``transient_fails`` attempts raise, then the alloc succeeds -- the
  engine's bounded retry loop must recover without failing the request
  (counted as ``faults_recovered``).

After EVERY injected fault the engine re-proves its invariants:
``BlockAllocator.check()`` passes and the commitment ledger matches the
allocator's atomic reservation counter (see the fault-sweep tests).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Tuple

import numpy as np

# Stable per-site key codes: part of the deterministic seed derivation,
# so reordering this table would silently reshuffle every plan's faults.
_SITE_CODES = {"poison": 1, "step": 2, "exhaust": 3, "transient": 4}


class InjectedFault(RuntimeError):
    """An injected fault firing at an engine injection site.

    ``kind`` names the site; ``uid`` the targeted request;
    ``transient`` marks faults a bounded retry is expected to clear;
    ``request_scoped`` feeds ``errors.is_request_scoped`` (every fault
    this module injects is attributable to one request by
    construction).
    """

    def __init__(self, kind: str, uid: int, *, transient: bool = False):
        super().__init__(f"injected {kind} fault (uid={uid})")
        self.kind = kind
        self.uid = uid
        self.transient = transient
        self.request_scoped = True


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject, at what rate, under which seed.

    Rates are per-decision probabilities in [0, 1]: ``poison_rate`` per
    request, ``step_fault_rate`` per (live slot, decode tick),
    ``alloc_exhaust_rate`` / ``transient_alloc_rate`` per block-growth
    event. ``poison_uids`` poisons specific requests on top of the rate
    draw (how the harness marks poison requests in a trace).
    ``transient_fails`` is how many attempts a transient alloc fault
    rejects before succeeding; the engine retries up to
    ``_GROW_RETRIES`` times, so ``transient_fails <= _GROW_RETRIES``
    recovers and anything larger degrades into a request-scoped
    failure. ``max_faults`` bounds total fires (0 = unbounded), keeping
    a long soak from degenerating into a fault storm.
    """

    seed: int = 0
    poison_rate: float = 0.0
    poison_uids: FrozenSet[int] = frozenset()
    step_fault_rate: float = 0.0
    alloc_exhaust_rate: float = 0.0
    transient_alloc_rate: float = 0.0
    transient_fails: int = 2
    max_faults: int = 0

    def __post_init__(self) -> None:
        for name in ("poison_rate", "step_fault_rate",
                     "alloc_exhaust_rate", "transient_alloc_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"FaultPlan.{name} must be in [0, 1], got {v}")
        if self.transient_fails < 1:
            raise ValueError(
                f"FaultPlan.transient_fails must be >= 1, got "
                f"{self.transient_fails}")
        if self.max_faults < 0:
            raise ValueError(
                f"FaultPlan.max_faults must be >= 0 (0 = unbounded), "
                f"got {self.max_faults}")
        # Make poison_uids hashable/frozen regardless of what iterable
        # the caller passed (frozen dataclass: go through __setattr__).
        object.__setattr__(
            self, "poison_uids", frozenset(self.poison_uids))


class FaultInjector:
    """Runtime decision-maker for one engine run under a FaultPlan.

    Holds only counters (fires so far, per-event transient attempt
    memory is unnecessary: attempts key the roll) -- all randomness is
    derived per decision from ``(seed, site, *key)`` via NumPy's
    ``SeedSequence``, so decisions are independent of call order.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injected = 0  # fault EVENTS fired (a transient counts once)
        # (kind, uid) of every fired event, in fire order -- what the
        # sweep tests assert exact failed-request sets against.
        self.events: List[Tuple[str, int]] = []

    def _roll(self, site: str, *key: int) -> float:
        seq = np.random.SeedSequence(
            [int(self.plan.seed), _SITE_CODES[site], *map(int, key)])
        return float(np.random.default_rng(seq).random())

    def _budget_left(self) -> bool:
        return (self.plan.max_faults == 0
                or self.injected < self.plan.max_faults)

    def _fire(self, kind: str, uid: int) -> None:
        self.injected += 1
        self.events.append((kind, uid))

    # ------------------------------------------------------------- sites
    def poison(self, uid: int) -> bool:
        """Should this request's prefill raise? (Once per admission
        ATTEMPT; a poisoned request stays poisoned on requeue.)"""
        p = self.plan
        hit = uid in p.poison_uids or (
            p.poison_rate > 0.0
            and self._roll("poison", uid) < p.poison_rate)
        if hit and self._budget_left():
            self._fire("poison", uid)
            return True
        return False

    def step_fault_one(self, uid: int, ticks: int) -> bool:
        """Should slot-scoped step handling for this request fail at its
        ``ticks``-th decode tick?"""
        p = self.plan
        if p.step_fault_rate <= 0.0 or not self._budget_left():
            return False
        if self._roll("step", uid, ticks) < p.step_fault_rate:
            self._fire("step", uid)
            return True
        return False

    def alloc_gate(self, uid: int, growth_idx: int, attempt: int) -> None:
        """Consulted before each lazy block-growth alloc attempt.

        Raises :class:`InjectedFault` to model the failure; returns
        normally to let the real allocator run. ``growth_idx`` is the
        request's owned-block count (a per-request monotone counter),
        ``attempt`` the retry number for THIS growth event.
        """
        p = self.plan
        if not self._budget_left():
            return
        if (p.alloc_exhaust_rate > 0.0
                and self._roll("exhaust", uid, growth_idx)
                < p.alloc_exhaust_rate):
            if attempt == 0:  # one event, however often retried
                self._fire("exhaust", uid)
            raise InjectedFault("alloc_exhausted", uid)
        if (p.transient_alloc_rate > 0.0
                and self._roll("transient", uid, growth_idx)
                < p.transient_alloc_rate):
            if attempt < p.transient_fails:
                if attempt == 0:
                    self._fire("transient", uid)
                raise InjectedFault("transient_alloc", uid,
                                    transient=True)

    # --------------------------------------------------------- reporting
    def failed_uids(self) -> FrozenSet[int]:
        """Uids of requests targeted by NON-recoverable fault events
        (everything but transients that the retry loop clears)."""
        return frozenset(
            uid for kind, uid in self.events if kind != "transient")


def poison_uids_for(n_requests: int, rate: float,
                    seed: int) -> FrozenSet[int]:
    """Seeded helper: pick ``ceil(rate * n)`` poison uids out of
    ``range(n_requests)`` -- how the serving harness marks poison
    requests in a generated trace (uids are positional there)."""
    if rate <= 0.0 or n_requests <= 0:
        return frozenset()
    k = max(1, int(np.ceil(rate * n_requests)))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 97]))
    return frozenset(
        int(u) for u in rng.choice(n_requests, size=min(k, n_requests),
                                   replace=False))
