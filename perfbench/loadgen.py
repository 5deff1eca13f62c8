"""The load generators' shared parts: the size mix, the request record
a client keeps, the clients that send requests and read their tokens,
and the window's timeline.

Every seed gets the same sizes: the mix is a fixed grid of (prompt,
budget) pairs at the laws' quantiles, and the seed only orders it and
draws the token ids. The grid is nested, so that every stretch of
requests asks for about the same work: each run of ``block`` requests
holds one prompt and one budget from each of the laws' ``block``
strata, and each run of ``block`` x ``fine`` requests holds every pair
of the grid once.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

# The pairing of prompt points with budget points: fixed for every seed.
_PAIRING_SEED = 20240917
# How often the clients read the tokens of the requests in flight.
POLL_S = 0.005


@dataclasses.dataclass
class Record:
    """One request as its client saw it (host clock, seconds)."""

    uid: int
    prompt_len: int
    budget: int
    seed: int
    vocab: int
    due: float = 0.0  # when the schedule sends it (0: at once)
    sent: float = 0.0  # when the client called submit
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    error: Optional[str] = None
    t_end: float = 0.0  # when it finished or failed

    def prompt(self) -> np.ndarray:
        """The request's token ids, drawn from (seed, uid)."""
        rng = np.random.default_rng([self.seed, self.uid])
        return rng.integers(0, self.vocab, self.prompt_len, dtype=np.int64)


def size_grid(p: Dict) -> List[List[Tuple[int, int]]]:
    """The mix's pairs by stratum: ``grid[c][f]`` is prompt point
    ``c * fine + f`` of the ``block * fine`` quantiles (i + 1/2) / (block
    * fine) of the log-uniform law over [prompt_min, prompt_max], with a
    budget point of the uniform law over [new_min, new_max] from stratum
    ``pc[c]``, point ``pf[f]`` within it (two fixed permutations)."""
    n, m = int(p["block"]), int(p["fine"])
    q = (np.arange(n * m) + 0.5) / (n * m)
    lo, hi = math.log(p["prompt_min"]), math.log(p["prompt_max"])
    prompts = np.rint(np.exp(lo + q * (hi - lo))).astype(int)
    budgets = np.rint(p["new_min"] + q * (p["new_max"] - p["new_min"])
                      ).astype(int)
    rng = np.random.default_rng(_PAIRING_SEED)
    pc, pf = rng.permutation(n), rng.permutation(m)
    return [[(int(prompts[c * m + f]), int(budgets[pc[c] * m + pf[f]]))
             for f in range(m)] for c in range(n)]


def nested(n: int, m: int, seed: int, tag: int) -> Iterator[Tuple[int, int]]:
    """Endless (stratum, point) indices over ``n`` strata of ``m`` points:
    pass after pass over all n x m, each pass ``m`` blocks holding one
    point of every stratum; which point, and the order within a block,
    drawn from (seed, tag, pass, ...)."""
    s = 0
    while True:
        cols = [np.random.default_rng([seed, tag, s, c]).permutation(m)
                for c in range(n)]
        for k in range(m):
            order = np.random.default_rng([seed, tag + 1, s, k]
                                          ).permutation(n)
            for c in order:
                yield int(c), int(cols[c][k])
        s += 1


def sizes(p: Dict, seed: int) -> Iterator[Tuple[int, int]]:
    """The endless request sizes of a seed: the grid's pairs in
    ``nested`` order."""
    grid = size_grid(p)
    for c, f in nested(len(grid), len(grid[0]), seed, 1):
        yield grid[c][f]


def residual_budgets(p: Dict, n: int, seed: int) -> List[int]:
    """``n`` budgets as a steady state finds the requests in service: the
    tokens a request still has to serve at a moment taken uniformly
    over its life, where a longer one is in service for longer:
    P(R = r) is proportional to the share of the grid's budgets at least
    r, for r >= 1. Taken at the quantiles (i + 1/2) / n, in an order
    drawn from the seed. A closed loop's first fill takes them, so that
    its completions, and so its admissions, come at the steady rate from
    the start and not all a budget's length later."""
    budgets = np.array([b for row in size_grid(p) for _, b in row])
    r = np.arange(1, int(budgets.max()) + 1)
    cdf = np.cumsum((budgets[None, :] >= r[:, None]).sum(1))
    cdf = cdf / cdf[-1]
    q = (np.arange(n) + 0.5) / n
    res = r[np.minimum(np.searchsorted(cdf, q), len(r) - 1)]
    order = np.random.default_rng([seed, 5]).permutation(n)
    return [int(res[i]) for i in order]


class Clients:
    """Every client of a cell on one thread: it sends each request at its
    due time and reads the tokens of all the requests in flight every
    ``POLL_S``, through their handles' streams, stamping each token on
    the host clock when it is read. One thread, so that the clients take
    the interpreter from the engine's thread at a steady, low rate,
    whatever the number of requests in flight. ``on_end(record)`` runs on
    that thread when a request finishes or fails."""

    def __init__(self, srv, timeout: float,
                 on_end: Optional[Callable[[Record], None]] = None):
        self.srv, self.timeout, self.on_end = srv, timeout, on_end
        self.records: List[Record] = []  # in the order sent
        self._due: List[tuple] = []  # heap of (due, uid, record)
        self._live: Dict[int, tuple] = {}  # uid -> (record, handle)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def send(self, rec: Record) -> None:
        """Send ``rec`` at ``rec.due`` (0: at once)."""
        with self._lock:
            heapq.heappush(self._due, (rec.due, rec.uid, rec))

    def join(self, timeout: float) -> bool:
        """Stop sending and reading (requests still in flight stay
        unfinished); True once the thread has ended."""
        self._stop.set()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            wake = time.perf_counter() + POLL_S
            while True:
                with self._lock:
                    head = self._due[0] if self._due else None
                    if head is None or head[0] > time.perf_counter():
                        break
                    heapq.heappop(self._due)
                self._submit(head[2])
            self._read()
            if head is not None:
                wake = min(wake, head[0])
            time.sleep(max(0.0, wake - time.perf_counter()))

    def _submit(self, rec: Record) -> None:
        prompt = rec.prompt()
        rec.sent = time.perf_counter()
        rec.due = rec.due or rec.sent
        self.records.append(rec)
        try:
            h = self.srv.submit(prompt, max_new=rec.budget, uid=rec.uid)
        except Exception as e:  # noqa: BLE001 - the run reports it
            rec.error = f"{type(e).__name__}: {e}"[:300]
            self._end(rec, time.perf_counter())
            return
        self._live[rec.uid] = (rec, h)

    def _read(self) -> None:
        for uid, (rec, h) in list(self._live.items()):
            t = time.perf_counter()
            try:
                for tok in h.stream(timeout=0):
                    rec.times.append(t)
                    rec.tokens.append(int(np.asarray(tok).reshape(-1)[0]))
            except TimeoutError:  # nothing more yet
                if t - (rec.times[-1] if rec.times else rec.sent) \
                        < self.timeout:
                    continue
                rec.error = f"TimeoutError: no token within {self.timeout} s"
            except Exception as e:  # noqa: BLE001 - the run reports it
                rec.error = f"{type(e).__name__}: {e}"[:300]
            else:
                rec.finished = True
            del self._live[uid]
            self._end(rec, t)

    def _end(self, rec: Record, t: float) -> None:
        rec.t_end = t
        if self.on_end is not None:
            self.on_end(rec)


def observe(serve, t_open: float, seconds: float, trace: bool, spans,
            slice_s: float, slices: int, harness) -> Dict:
    """The window's timeline on the calling thread: the engine's counters
    at the open and the close (and around each profiled slice: a traced
    window holds up to ``slices`` of ``slice_s`` seconds, spread evenly
    over it; one that would end, with a stop as long as the last one's,
    past the close is left out), the device's peak memory over the
    window, and the queue depth sampled every quarter second."""
    import torch
    wait_until(t_open)
    out: Dict = {"t_open": t_open, "depth": [], "profiled": [],
                 "peak_setup_bytes": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    snaps = [("open", time.perf_counter(), serve.counters())]
    t_close = t_open + seconds
    for i in range(slices if trace else 0):
        start = t_open + (i + 1) * seconds / (slices + 1) - slice_s / 2
        stop_s = out["profiled"][-1].stop_s if out["profiled"] else 0.0
        if max(start, time.perf_counter()) + slice_s + stop_s > t_close:
            break
        _sample_depth(serve, out, start)
        snaps.append((f"slice_start.{i}", time.perf_counter(),
                      serve.counters()))
        prof = harness.Profiled(spans)
        serve.hook.call(prof.start)
        _sample_depth(serve, out, prof.t0 + slice_s)
        serve.hook.call(prof.stop)
        snaps.append((f"slice_end.{i}", time.perf_counter(),
                      serve.counters()))
        out["profiled"].append(prof)
    _sample_depth(serve, out, t_close)
    snaps.append(("close", time.perf_counter(), serve.counters()))
    out["t_close"] = t_close
    out["snaps"] = snaps
    out["peak_window_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _sample_depth(serve, out: Dict, until: float) -> None:
    while True:
        now = time.perf_counter()
        if now >= until:
            return
        out["depth"].append((now, serve.queue_depth()))
        time.sleep(min(0.25, until - now))


def wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))
