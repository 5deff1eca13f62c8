"""SLO-aware prefill/decode scheduling for the serving engine.

The engine has exactly one expensive choice to make per iteration: run
the next DECODE tick for the requests already in flight, or spend the
gap ADMITTING a queued request (a bucketed batch=1 prefill + cache
scatter). Prefill stalls every in-flight request's next token by the
prefill's cost, so admitting greedily (the drain engine's policy)
maximizes throughput but lets inter-token latency spike; never admitting
starves the queue. This module owns that trade-off, which is the
serving-layer analogue of the paper's core constraint: skipping /
re-ordering work is only a win if the control path that decides to do so
is cheap and never stalls the main pipeline -- the decision below is a
handful of float compares on host-side state.

Virtual clock
-------------
All decisions run on a VIRTUAL clock denominated in decode-tick units
(:class:`repro_torch.core.cost_model.TickCosts`): a decode tick advances it by
1.0, a prefill of a ``rows``-bucket by ``prefill_ticks(rows)``. Wall
time is recorded alongside for reporting, but never consulted for a
decision, so the admission schedule -- and every SLO statistic gated in
CI -- is a deterministic function of the seeded arrival trace. The
virtual clock charges GLOBAL-config tick costs even on a (data, model)
serving mesh -- a sharded tick is the same logical work -- which is one
of the invariants that keep the sharded engine's schedule (and its SLO
gates) identical to the single-host run.

Policy (:meth:`Scheduler.admit_head`), evaluated for the queue HEAD only
(head-of-line order keeps the schedule deterministic; see
``runtime/queueing.py``):

  1. **drain mode** (``slo is None``): always admit while a slot and the
     KV-block commitment fit -- byte-for-byte the drain engine policy,
     which is what keeps ``Server.generate`` parity tests green.
  2. **forced by TTFT**: if waiting one more tick would push the head's
     time-to-first-token past its budget (per-request ``deadline_ticks``
     or ``SLOConfig.target_ttft_ticks``), admit now regardless of the
     ITL cost. This is the anti-starvation clause: decode-heavy load
     cannot defer a queued request forever.
  3. **idle**: nothing in flight -> admit (a decode tick over zero live
     slots helps nobody).
  4. **ITL headroom**: admit only if the prefill fits inside the
     inter-token budget: 1 (the next decode tick) + cost of prefills
     already admitted this round + this prefill <= ``target_itl_ticks``.
     Otherwise defer and let the decode tick run.

Thread-safety: a ``Scheduler`` instance is owned by the single engine
thread; it holds no locks and must not be shared across threads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cost_model import TickCosts


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency targets for live serving, in decode-tick units.

    ``target_ttft_ticks`` -- budget from ARRIVAL to first token (the
    first token comes from the prefill logits, so this bounds queue wait
    + prefill). ``target_itl_ticks`` -- budget between consecutive
    tokens of a running request; 1.0 is the floor (one decode tick), and
    the gap above 1.0 is the room the scheduler may fill with prefills.
    ``admit_headroom`` scales the TTFT budget used by the forced-admit
    clause: < 1.0 admits early (safety margin), 1.0 admits at the last
    tick that can still meet the budget.

    Tick units are deliberate: they are deterministic on any host.
    ``TickCosts.tick_seconds`` converts to modeled wall time (the reference cost model's
    roofline); see docs/SERVING.md for tuning guidance.

    Validation runs in ``__post_init__`` (the config is rejected at
    construction, before any engine exists to misbehave).
    """

    target_ttft_ticks: float = 64.0
    target_itl_ticks: float = 8.0
    admit_headroom: float = 1.0

    def __post_init__(self) -> None:
        if not self.target_ttft_ticks > 0:
            raise ValueError(
                f"SLOConfig.target_ttft_ticks must be > 0, got "
                f"{self.target_ttft_ticks}; it budgets arrival->first "
                "token in decode ticks"
            )
        if not self.target_itl_ticks >= 1.0:
            raise ValueError(
                f"SLOConfig.target_itl_ticks must be >= 1.0, got "
                f"{self.target_itl_ticks}; one decode tick is the floor "
                "between consecutive tokens, so a smaller budget can "
                "never be met"
            )
        if not self.admit_headroom > 0:
            raise ValueError(
                f"SLOConfig.admit_headroom must be > 0, got "
                f"{self.admit_headroom}; it scales the TTFT budget of "
                "the forced-admit clause"
            )


class Scheduler:
    """Per-tick prefill-vs-decode decisions against a :class:`SLOConfig`.

    Mutable state is only the per-round admitted-prefill cost and the
    decision counters (surfaced in ``Server.metrics``); everything else
    comes in through the call arguments, so the same instance replayed
    over the same trace produces the same schedule.
    """

    def __init__(self, costs: TickCosts, slo: Optional[SLOConfig] = None,
                 max_queue_depth: Optional[int] = None):
        self.costs = costs
        self.slo = slo
        self.max_queue_depth = max_queue_depth
        self._round_cost = 0.0  # prefill ticks already admitted this round
        # Decision telemetry (lifetime of the scheduler).
        self.admitted = 0
        self.deferred = 0
        self.forced = 0
        self.reclaims = 0  # preemptions the reclaim policy approved
        self.sheds = 0  # pushes the shed policy rejected

    # One "round" = the admission phase preceding one decode tick.
    def begin_round(self) -> None:
        self._round_cost = 0.0

    def ttft_budget(self, deadline_ticks: Optional[float]) -> float:
        if deadline_ticks is not None:
            return float(deadline_ticks)
        if self.slo is not None:
            return self.slo.target_ttft_ticks
        return float("inf")

    def admit_head(self, *, wait_ticks: float, prefill_ticks: float,
                   n_active: int,
                   deadline_ticks: Optional[float] = None) -> bool:
        """Admit the queue head now, or defer to the decode tick?

        ``wait_ticks``: virtual ticks the head has already queued.
        ``prefill_ticks``: modeled cost of its (bucketed) prefill. With
        the prefix cache on, the engine passes the SUFFIX bucket's cost
        here (the cached prefix rows never run), so a prefix hit
        shrinks the admission cost and the same clauses below admit
        more aggressively without any policy change -- cache-aware
        admission falls out of pricing the work that actually runs.
        The worst-case block reservation shrinks the same way on the
        allocator side (shared blocks need no commitment).
        ``n_active``: live slots that a prefill would stall.
        """
        if self.slo is None:  # drain mode: the greedy policy
            self.admitted += 1
            return True
        budget = self.ttft_budget(deadline_ticks)
        # wait_ticks is measured against the engine's LIVE virtual clock,
        # which already advanced past this round's earlier prefills --
        # adding _round_cost here would double-count them and spuriously
        # force-admit. _round_cost belongs only to the ITL clause below
        # (the gap in-flight requests will see from this round).
        would_finish = wait_ticks + prefill_ticks
        if would_finish + 1.0 > budget * self.slo.admit_headroom:
            # Deferring one tick would miss TTFT: admit now (forced).
            self.forced += 1
            self.admitted += 1
            self._round_cost += prefill_ticks
            return True
        if n_active == 0:
            self.admitted += 1
            self._round_cost += prefill_ticks
            return True
        if 1.0 + self._round_cost + prefill_ticks <= self.slo.target_itl_ticks:
            self.admitted += 1
            self._round_cost += prefill_ticks
            return True
        self.deferred += 1
        return False

    def ttft_forced(self, *, wait_ticks: float, prefill_ticks: float,
                    deadline_ticks: Optional[float] = None) -> bool:
        """Is the head in forced-TTFT territory (deferring one more tick
        would miss its budget)? Same formula as ``admit_head``'s forced
        clause, but side-effect free -- the reclaim policy probes it
        before any resources move."""
        budget = self.ttft_budget(deadline_ticks)
        if budget == float("inf"):
            return False
        headroom = self.slo.admit_headroom if self.slo is not None else 1.0
        return wait_ticks + prefill_ticks + 1.0 > budget * headroom

    def should_reclaim(self, *, wait_ticks: float, prefill_ticks: float,
                       deadline_ticks: Optional[float],
                       restore_ticks: float,
                       free_wait_ticks: float) -> bool:
        """Preempt a running victim to fund the head's admission?

        The serving-layer form of the paper's squash-vs-skip cost
        argument: evicting a running request "squashes" work already in
        flight, and the squash penalty is ``restore_ticks`` -- the
        re-prefill of the victim's written prefix when it is later
        restored (cheap, suffix-only, when the prefix cache kept its
        blocks; a full re-prefill otherwise). Reclaim only pays when

          1. the head is FORCED (waiting one more tick misses its TTFT
             budget -- per-request ``deadline_ticks`` or the config
             SLO; without either there is no damage to trade against),
             and
          2. the squash penalty beats the stall: ``restore_ticks <=
             free_wait_ticks``, the ticks until the earliest natural
             slot release would free capacity anyway.

        The engine picks the victim (lowest priority, then most
        recently admitted -- least sunk work per the same penalty
        logic) and only offers strictly-lower-priority candidates.
        """
        if not self.ttft_forced(wait_ticks=wait_ticks,
                                prefill_ticks=prefill_ticks,
                                deadline_ticks=deadline_ticks):
            return False
        if restore_ticks > free_wait_ticks:
            return False  # squashing costs more than waiting out a slot
        self.reclaims += 1
        return True

    def should_shed(self, queue_depth: int) -> bool:
        """Shed an arriving request instead of queueing it? The depth
        bound is the engine's configured ``max_queue_depth``: past it,
        every additional entry only pushes every TTFT further past
        budget, so typed backpressure (:class:`ServerOverloaded`) at
        the door beats silent queueing. Decide-before-fetch, applied to
        admission: reject before ANY resources are spent on the
        request."""
        if (self.max_queue_depth is not None
                and queue_depth >= self.max_queue_depth):
            self.sheds += 1
            return True
        return False
