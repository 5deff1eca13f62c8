"""Typed error hierarchy for the serving runtime.

Every failure the engine can surface to a client crosses one of these
types, so callers (and the HTTP front end to come) can branch on CLASS
instead of parsing message strings:

* :class:`ServerOverloaded` -- load shedding: the admission queue is at
  its configured depth bound (``ServeConfig.max_queue_depth``) and the
  scheduler's shed policy rejected the push. Raised synchronously from
  ``enqueue``/``AsyncServer.submit``; nothing was enqueued, retry later.
* :class:`RequestCancelled` -- the request was cancelled (explicit
  ``cancel()`` or its ``max_ticks`` decode deadline expired) after
  submission. Its slot and KV blocks were released; any tokens produced
  before the cancel are attached to ``Request.out``.
* :class:`RequestFailed` -- a REQUEST-SCOPED engine fault (poison
  prompt, injected/step fault, allocator exhaustion for this request's
  growth): only this request failed, its resources were released with
  the commitment ledger intact, and the engine keeps serving everyone
  else.
* :class:`EngineFatal` -- an engine-scoped fault that cannot be
  attributed to one request (a fused-tick exception poisons every
  slot's logits). This is the fail-all path: all outstanding
  submissions fail and the engine stops.

The split mirrors the paper's squash-vs-skip argument at the failure
level: request-scoped containment "squashes" only the instructions that
belong to the faulting request, while everything independent keeps
flowing through the pipeline.

``is_request_scoped`` is the classification point the engine uses: it
must stay conservative -- anything not provably attributable to one
request escalates to the fatal path rather than silently corrupting
neighbours.
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for all typed serving-runtime errors."""


class ServerOverloaded(ServingError):
    """Admission queue at its depth bound: the push was shed. Nothing
    was enqueued; the client should back off and retry."""


class RequestCancelled(ServingError):
    """The request was cancelled after submission (client ``cancel()``
    or its per-request ``max_ticks`` decode deadline). Resources were
    released; partial output (if any) is on ``Request.out``."""


class RequestFailed(ServingError):
    """A request-scoped engine fault: only this request failed and was
    evicted; the engine keeps serving. The original fault is chained as
    ``__cause__``."""


class EngineFatal(ServingError):
    """An engine-scoped fault: the failure cannot be attributed to one
    request, so every outstanding submission fails and the engine
    stops. The original fault is chained as ``__cause__``."""


def is_request_scoped(exc: BaseException) -> bool:
    """Classify an exception raised while handling ONE request's work
    (its prefill, its block growth): can the engine contain it to that
    request alone?

    Deliberately conservative: ``ValueError``/``FloatingPointError``
    from a single-request host path are prompt-shaped problems
    (malformed input, bad lengths) that cannot have touched other
    slots' state. Everything else -- allocator invariant violations,
    CUDA runtime errors from fused multi-slot computations,
    MemoryError -- escalates to the engine-fatal fail-all path. (The
    reference's seeded fault injector, whose faults carry their own
    scope, is not ported yet.)
    """
    return isinstance(exc, (ValueError, FloatingPointError))
