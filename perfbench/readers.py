"""Helpers the metric readers share. A reader gets the run's context:
the records of the requests or steps, the window's bounds, the engine's
counters around the window and the profiled slices, the trace's
reading and the kernel calls' work. The intervals a metric covers leave
out the profiled slices, whose profiler slows the host."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from perfbench import harness, work


def _stretches(ctx) -> List[Tuple[str, str]]:
    """The names of the snapshots that bound the window's unprofiled
    stretches: open to the first slice's start, each slice's end to the
    next one's start, the last one's end to the close."""
    names = [n for n, _, _ in ctx["snaps"]
             if n == "open" or n == "close" or n.startswith("slice_")]
    return list(zip(names[::2], names[1::2]))


def intervals(ctx) -> List[Tuple[float, float]]:
    """The window's unprofiled stretches (the whole window when the run
    is not traced)."""
    t = {name: at for name, at, _ in ctx["snaps"]}
    t["open"], t["close"] = ctx["t_open"], ctx["t_close"]
    return [(t[a], t[b]) for a, b in _stretches(ctx)]


def counter_delta(ctx) -> Dict[str, float]:
    """The engine's counters summed over the unprofiled stretches."""
    c = {name: v for name, _, v in ctx["snaps"]}
    out: Dict[str, float] = {}
    for lo, hi in _stretches(ctx):
        for k in c[lo]:
            out[k] = out.get(k, 0.0) + c[hi][k] - c[lo][k]
    return out


def inside(t: float, ivs) -> bool:
    return any(a <= t < b for a, b in ivs)


def span(ivs) -> float:
    return sum(b - a for a, b in ivs)


def pct(xs: List[float], q: float) -> Optional[float]:
    v = harness.quantiles(xs, q)
    return None if v is None or v == float("inf") else v


def serve_flops(ctx, ivs) -> float:
    """The model step's FLOPs of the tokens delivered inside ``ivs``:
    a request's first token brings its prefill, each later one its
    decode at its context."""
    model = ctx["model"]
    total = 0.0
    for r in ctx["records"]:
        for j, t in enumerate(r.times):
            if not inside(t, ivs):
                continue
            total += (work.prefill_flops(model, r.prompt_len) if j == 0
                      else work.decode_flops(model, r.prompt_len + j))
    return total


def unprofiled_steps(ctx) -> list:
    return [s for s in ctx["steps"] if not s["profiled"]]


# The readers that metric files of data name (``metrics/<metric>.json``:
# {"reader": <function here>, "args": {...}}), shared by many cells.
def roofline(ctx, entry: str) -> Optional[float]:
    """The kernel entry point's share of its roofline: the least time the
    card could take for its calls' work in the profiled slices (the
    larger of FLOPs over 989.4 TFLOP/s and bytes over 3.35 TB/s, counted
    from shapes and live tiles or blocks by ``work.py``) over the device
    time recorded under those calls' spans."""
    tr, spans = ctx.get("trace"), ctx.get("spans")
    if tr is None or spans is None:
        return None
    return harness.roofline_share(spans.work(entry),
                                  tr.by_span.get(entry, {}),
                                  work.PEAK_FLOPS, work.HBM_BW)


def idle_share(ctx) -> Optional[float]:
    """Share of the profiled slices in which no operation ran on the
    card."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def peak_mem_gib(ctx) -> float:
    """torch.cuda.max_memory_allocated() over the window (reset at its
    open), in GiB."""
    return ctx["peak_window_bytes"] / 2 ** 30


def tick_ms(ctx) -> Optional[float]:
    """Host milliseconds of the engine's decode ticks over their count,
    in the window's unprofiled stretches (ServeMetrics.decode_s /
    ticks)."""
    d = counter_delta(ctx)
    return 1e3 * d["decode_s"] / d["ticks"] if d["ticks"] else None


def prefill_ms_per_ktok(ctx) -> Optional[float]:
    """Host milliseconds of the engine's prefill calls per thousand real
    prompt tokens, in the window's unprofiled stretches."""
    d = counter_delta(ctx)
    k = d["prefill_tokens"] / 1e3
    return 1e3 * d["prefill_s"] / k if k else None


def ttft_ms(r) -> float:
    """A request's due time to its first token, inf without one."""
    return (r.times[0] - r.due) * 1e3 if r.times else float("inf")
