"""Open loop: independent users, each request sent at its due time on a
fixed schedule whatever the system's state (a service that many users
call).

Parameters: ``rate`` (requests/s); the size mix (``prompt_min``,
``prompt_max``, ``new_min``, ``new_max``, ``block``, ``fine``, see
``loadgen.size_grid``); ``gap_block`` and ``gap_fine``: the gaps
between arrivals are the exponential law's quantiles (i + 1/2) / (block
x fine) in strata of ``gap_fine`` (see ``gaps``), so every seed offers
the same arrivals in another order; ``lead_s``: the schedule starts this long before the window opens, so that the window
opens on a steady queue; ``tail_wait_s``: after the close the schedule
goes on (the load does not drop) until every request due in the window
has its first token, or this many seconds have passed; ``slice_s`` and
``slices``: a traced window's profiled slices.

A request is timed from its due time. The requests due in the window
are the attempted ones; one that fails or gets no first token failed.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator

import numpy as np

from perfbench import loadgen

TOKEN_TIMEOUT_S = 300.0


def gaps(p: Dict, seed: int) -> Iterator[float]:
    """The seconds between consecutive arrivals of a seed: the
    exponential law's ``gap_block * gap_fine`` quantiles, in
    ``loadgen.nested`` order over ``gap_block`` strata, scaled so that
    they last on average 1 / rate."""
    n, m = int(p["gap_block"]), int(p["gap_fine"])
    q = (np.arange(n * m) + 0.5) / (n * m)
    g = -np.log1p(-q)
    g *= n * m / (g.sum() * float(p["rate"]))
    for c, f in loadgen.nested(n, m, seed, 3):
        yield float(g[c * m + f])


def run(serve, cell, seed: int, seconds: float, trace: bool, harness
        ) -> Dict:
    p = cell.workload["params"]
    vocab = cell.config["model"]["vocab_size"]
    mix, gap = loadgen.sizes(p, seed), gaps(p, seed)
    clients = loadgen.Clients(serve.srv, TOKEN_TIMEOUT_S)
    t_start = time.perf_counter() + 0.5
    t_open = t_start + float(p["lead_s"])
    end = t_open + seconds + float(p["tail_wait_s"])
    due, uid = t_start, 1
    while due < end:
        prompt, budget = next(mix)
        clients.send(loadgen.Record(uid, prompt, budget, seed, vocab,
                                    due=due))
        due += next(gap)
        uid += 1
    out = loadgen.observe(serve, t_open, seconds, trace, serve.spans,
                          p["slice_s"], int(p["slices"]), harness)
    a, b = out["t_open"], out["t_close"]
    due_in = [r for r in list(clients.records) if a <= r.due < b]
    end = b + float(p["tail_wait_s"])
    while time.perf_counter() < end and any(
            not r.times and r.error is None for r in due_in):
        time.sleep(0.05)
    clients.join(30)
    out["snaps"].append(("first_tokens", time.perf_counter(),
                         serve.counters()))
    failed = [r for r in due_in if r.error is not None or not r.times]
    out.update(records=clients.records, t_start=t_start,
               attempted=due_in, failed=failed)
    return out
