"""Closed loop: a fixed number of clients, each sending its next request
when its last one completes (pipelines that wait for every reply).

Parameters: ``clients``; the size mix (``prompt_min``, ``prompt_max``,
``new_min``, ``new_max``, ``block``, ``fine``, see
``loadgen.size_grid``); ``warm_completions``: the window opens once
every slot is busy and that many requests have completed since the
clients started; ``slice_s`` and ``slices``: a traced window's profiled
slices. The requests of the first fill, one a slot, take the budgets a
steady state would find in service (``loadgen.residual_budgets``), so
that the batch turns over at its steady rate from the fill on; every
later request takes its budget from the mix.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict

from perfbench import loadgen

TOKEN_TIMEOUT_S = 300.0


def run(serve, cell, seed: int, seconds: float, trace: bool, harness
        ) -> Dict:
    p = cell.workload["params"]
    slots = cell.config["engine"]["batch_slots"]
    vocab = cell.config["model"]["vocab_size"]
    mix = loadgen.sizes(p, seed)
    first = loadgen.residual_budgets(p, slots, seed)
    uids = itertools.count(1)
    clients = None

    def request():
        prompt, budget = next(mix)
        uid = next(uids)
        if uid <= slots:
            budget = first[uid - 1]
        return loadgen.Record(uid, prompt, budget, seed, vocab)

    def on_end(rec):
        if rec.error is None:  # a client whose request failed stops
            clients.send(request())

    base = serve.counters()
    clients = loadgen.Clients(serve.srv, TOKEN_TIMEOUT_S, on_end)
    t_start = time.perf_counter()
    for _ in range(int(p["clients"])):
        clients.send(request())
    while True:
        c = serve.counters()
        busy = (c["admitted"] - c["completed"]) >= slots
        turned = c["completed"] - base["completed"] >= p["warm_completions"]
        if busy and turned:
            break
        if time.perf_counter() - t_start > 900:
            raise RuntimeError("the closed loop never filled the slots")
        time.sleep(0.02)
    harness.log(f"ramp done after {time.perf_counter() - t_start:.1f} s")
    out = loadgen.observe(serve, time.perf_counter(), seconds, trace,
                          serve.spans, p["slice_s"], int(p["slices"]),
                          harness)
    clients.join(30)
    out.update(records=clients.records, t_start=t_start)
    _log_turnover(out, harness)
    return out


def _log_turnover(out: Dict, harness) -> None:
    """Tokens delivered per 10 s from the clients' start to the close,
    and in the window's two halves: a steady window reads the same in
    both."""
    t0, a, b = out["t_start"], out["t_open"], out["t_close"]
    times = [t for r in out["records"] for t in r.times if t < b]
    bins = [0] * (int((b - t0) // 10) + 1)
    for t in times:
        bins[int((t - t0) // 10)] += 1
    mid = (a + b) / 2
    halves = [sum(1 for t in times if a <= t < mid),
              sum(1 for t in times if mid <= t < b)]
    harness.log(f"tokens per 10 s from the start: {bins}; window opened "
                f"at {a - t0:.1f} s; halves {halves}")
