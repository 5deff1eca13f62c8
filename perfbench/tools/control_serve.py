"""Read a served cell's check on the card for one seed: the program's
number and its control's, on the same sample of requests.

    python3 perfbench/tools/control_serve.py --workload nemo12b.rag.batch \
        --seed 11 --seconds 10

One seed a process: a second engine built in the same process did not
find the first one's KV pool freed. It runs the cell as a run does
(set-up, the load generator for a short window at the cell's own load,
the engine stopped), draws the check's sample of finished requests,
and prints one JSON line: the widest logit gap of the served tokens
against the f32 reference (the program's reading) and of the tokens
that the reference computed in float8 e4m3 puts first at the same
positions (the control's reading, which has to come out above the
limit). The program's readings of a dozen seeds and the control's of
three or more set the limit in the configuration's file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness  # noqa: E402
from perfbench.systems import serve as serve_sys  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    device = harness.require_devices(cell.chips)
    traffic = harness.load_module("traffic", cell.workload["traffic"])
    lim = cell.config["limits"]
    seed = args.seed
    t0 = time.perf_counter()
    serve = serve_sys.build(cell, seed, device, trace=False)
    out = traffic.run(serve, cell, seed, args.seconds, False, harness)
    serve_sys.stop(serve)
    a, b = out["t_open"], out["t_close"]
    done = [r for r in out["records"] if r.finished and a <= r.t_end <= b]
    reqs = serve_sys.sample(done, seed, lim["sample_requests"])
    prog = serve_sys.logit_gaps(serve.params, serve.model, reqs, device)
    ctl = serve_sys.logit_gaps(serve.params, serve.model, reqs, device,
                               fp8=True)
    print(json.dumps({
        "seed": seed, "program": max(prog), "control": max(ctl),
        "program_each": prog, "control_each": ctl,
        "tokens": sum(len(r.tokens) for r in reqs),
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
