"""Find the highest arrival rate an open-loop served cell sustains: one
set-up, then the cell's open loop at each rate in turn (ascending), the
engine drained between rates.

    python3 perfbench/tools/sweep_open.py --workload nemo12b.rag.open \
        --rates 0.5,0.75,1.0,1.25,1.5 --seconds 40 --seed 0

A rate is sustained when no request fails and the queue at the window's
end (its depth averaged over the last five seconds) is no deeper than at
its first third (averaged over five seconds around it). One JSON line a
rate: those depths, the TTFT and ITL percentiles and the counts. It
stops after the first rate that is not sustained.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness, readers  # noqa: E402
from perfbench.systems import serve as serve_sys  # noqa: E402


def mean_depth(depth, lo: float, hi: float) -> float:
    xs = [d for t, d in depth if lo <= t <= hi]
    return statistics.fmean(xs) if xs else float("nan")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    device = harness.require_devices(cell.chips)
    print(f"card: {harness.card_note()}", file=sys.stderr, flush=True)
    traffic = harness.load_module("traffic", cell.workload["traffic"])
    serve = serve_sys.build(cell, args.seed, device, trace=False)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.workload["params"]["rate"] = rate
        out = traffic.run(serve, cell, args.seed, args.seconds, False,
                          harness)
        serve.srv.drain(timeout=900)
        a, b = out["t_open"], out["t_close"]
        third = a + (b - a) / 3
        first = mean_depth(out["depth"], third - 2.5, third + 2.5)
        end = mean_depth(out["depth"], b - 5.0, b)
        ttft = [readers.ttft_ms(r) for r in out["attempted"]]
        itl = [(t1 - t0) * 1e3 for r in out["records"]
               for t0, t1 in zip(r.times, r.times[1:]) if a <= t0 and t1 < b]
        ok = not out["failed"] and end <= first
        row = {"rate": rate, "sustained": ok, "depth_first_third": first,
               "depth_end": end, "due": len(out["attempted"]),
               "failed": len(out["failed"]),
               "ttft_ms": {q: readers.pct(ttft, q / 100)
                           for q in (50, 75, 90)},
               "itl_ms": {q: readers.pct(itl, q / 100) for q in (50, 95)},
               "ttft_p50_by_third_ms": [
                   readers.pct([readers.ttft_ms(r) for r in out["attempted"]
                                if lo <= r.due < lo + (b - a) / 3], 0.5)
                   for lo in (a, third, a + 2 * (b - a) / 3)],
               "depth": [[round(t - a, 2), d] for t, d in out["depth"]
                         ][::8]}
        print(json.dumps(row), flush=True)
        if not ok:
            break
    serve_sys.stop(serve)
    return 0


if __name__ == "__main__":
    sys.exit(main())
