"""Thread-safe admission queue for the live serving engine.

This is the boundary between the OUTSIDE world (client threads calling
:meth:`repro_torch.runtime.server.AsyncServer.submit`) and the single engine
thread that owns all model/cache state. Everything here is host-side
pure Python; nothing in this module touches torch.

Ordering contract
-----------------
Entries pop in ``(-priority, arrival_seq)`` order: higher ``priority``
first, FIFO within a priority class. The engine only ever examines the
HEAD of the queue (head-of-line admission, like the original drain engine's
deque): a head that does not fit the KV pool blocks everything behind
it. That head-blocking is deliberate -- it is what makes admission order
(and therefore token outputs and skip statistics) a deterministic
function of the arrival trace, which the serving parity tests and the CI
SLO gate rely on.

Thread-safety
-------------
``RequestQueue`` is multi-producer / SINGLE-consumer:

  * :meth:`push`, :meth:`depth`, :meth:`close` may be called from any
    thread (each takes the internal lock).
  * :meth:`peek` / :meth:`pop` / :meth:`pop_expected` must only be
    called by the one engine thread. A concurrent push CAN change the
    head between a ``peek`` and a ``pop`` (a higher-priority arrival
    becomes the new head), so the engine removes the entry it actually
    admitted with :meth:`pop_expected`, which takes the peeked entry by
    identity -- a bare ``pop`` after a stale ``peek`` would discard the
    newcomer and double-admit the old head.

The engine's idle/wake signalling lives in ``AsyncServer`` (its
condition variable also covers slot state, which this queue cannot
see); the queue itself only orders and counts entries. :meth:`close` is
the shutdown latch: ``AsyncServer.shutdown`` closes the queue so a
straggler ``submit`` racing the teardown fails loudly here rather than
enqueueing into a dead engine.

Timestamps
----------
Each entry carries two clocks: ``arrival_s`` (wall time, for reported
latency metrics) and ``arrival_vt`` (the engine's deterministic virtual
tick clock, see :mod:`repro_torch.runtime.scheduler`), which is what every
scheduling decision and every CI-gated statistic uses.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Any, Callable, List, Optional

from repro_torch.runtime.errors import ServerOverloaded


@dataclasses.dataclass
class QueuedRequest:
    """One queue entry: a ``server.Request`` plus admission metadata.

    ``req`` is duck-typed (``repro_torch.runtime.server.Request``) to keep this
    module import-free of the server.

    ``deadline_ticks`` is a per-request time-to-first-token budget in
    virtual ticks, overriding ``SLOConfig.target_ttft_ticks`` for this
    request only; ``None`` falls back to the config-wide target.
    """

    req: Any
    seq: int
    priority: float = 0.0
    arrival_vt: float = 0.0
    arrival_s: float = 0.0
    deadline_ticks: Optional[float] = None

    def sort_key(self):
        return (-self.priority, self.seq)


class RequestQueue:
    """Priority + FIFO admission queue (multi-producer, single-consumer).

    Invariants:
      * ``depth()`` == number of entries not yet popped;
      * ``depth_peak`` only grows, and is >= every depth() ever observed;
      * after :meth:`close`, :meth:`push` raises -- the engine can drain
        the remaining entries and then terminate knowing no more arrive;
      * with ``max_depth`` set, ``depth() <= max_depth`` always: a push
        into a full queue raises :class:`ServerOverloaded` (typed
        backpressure; the entry is NOT enqueued) and is counted in
        ``shed``. Internal pushes that must not shed -- the engine
        requeueing a preempted request whose resources it just
        released -- pass ``force=True``.
    """

    def __init__(self, max_depth: Optional[int] = None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(
                f"RequestQueue max_depth must be >= 1 (or None for "
                f"unbounded), got {max_depth}")
        self._lock = threading.RLock()
        self._heap: List[tuple] = []  # (sort_key, QueuedRequest)
        self._seq = 0
        self._closed = False
        self.max_depth = max_depth
        self.depth_peak = 0
        self.shed = 0  # pushes rejected by the depth bound

    def push(self, req: Any, *, priority: float = 0.0,
             arrival_vt: float = 0.0,
             deadline_ticks: Optional[float] = None,
             arrival_s: Optional[float] = None,
             force: bool = False) -> QueuedRequest:
        """Enqueue a request; safe from any thread. Returns the entry.

        Raises :class:`ServerOverloaded` when the depth bound is hit
        (unless ``force``, the engine-internal requeue path -- a
        preempted request already holds a place in the system, so
        bouncing it on the bound it vacated a slot for would deadlock
        the reclaim policy)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("RequestQueue is closed")
            if (self.max_depth is not None and not force
                    and len(self._heap) >= self.max_depth):
                self.shed += 1
                raise ServerOverloaded(
                    f"admission queue at max_depth="
                    f"{self.max_depth}: request "
                    f"uid={getattr(req, 'uid', '?')} shed")
            item = QueuedRequest(
                req=req, seq=self._seq, priority=float(priority),
                arrival_vt=float(arrival_vt),
                arrival_s=time.perf_counter() if arrival_s is None
                else arrival_s,
                deadline_ticks=deadline_ticks,
            )
            self._seq += 1
            heapq.heappush(self._heap, (item.sort_key(), item))
            self.depth_peak = max(self.depth_peak, len(self._heap))
            return item

    def peek(self) -> Optional[QueuedRequest]:
        """Head entry without removing it (engine thread only)."""
        with self._lock:
            return self._heap[0][1] if self._heap else None

    def pop(self) -> QueuedRequest:
        """Remove and return the head entry (engine thread only)."""
        with self._lock:
            if not self._heap:
                raise IndexError("pop from an empty RequestQueue")
            return heapq.heappop(self._heap)[1]

    def pop_expected(self, item: QueuedRequest) -> QueuedRequest:
        """Remove exactly ``item`` (a previously peeked entry), even if a
        concurrent push has since put a different entry at the head.
        The heap rebuild in the raced case is O(n) -- the race is rare
        and the queue is the small host-side admission queue."""
        with self._lock:
            if self._heap and self._heap[0][1] is item:
                return heapq.heappop(self._heap)[1]
            kept = [e for e in self._heap if e[1] is not item]
            if len(kept) != len(self._heap) - 1:
                raise RuntimeError(
                    "pop_expected: entry is no longer queued")
            self._heap = kept
            heapq.heapify(self._heap)
            return item

    def remove_if(self, pred: Callable[[QueuedRequest], bool]
                  ) -> List[QueuedRequest]:
        """Remove and return every queued entry matching ``pred``
        (engine thread only; used to purge cancelled requests before
        they reach a slot). O(n) rebuild -- cancellation is rare and the
        queue is the small host-side admission queue."""
        with self._lock:
            removed = [e[1] for e in self._heap if pred(e[1])]
            if removed:
                self._heap = [e for e in self._heap
                              if not pred(e[1])]
                heapq.heapify(self._heap)
            return removed

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def __len__(self) -> int:
        return self.depth()

    def close(self) -> None:
        """Refuse further pushes (shutdown latch; already-queued entries
        can still be popped and drained)."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
