"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. It builds the cell's system on the card
from the seed, warms every shape its traffic uses (set-up), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on stdout: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(read from a profiled slice in the middle of the window). Without a
CUDA card, or with fewer cards than the cell asks for, it prints no
result and exits 2. It exits 3 if a module of the JAX stack or of the
package the port was made from was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def read_metrics(cell: harness.Cell, section: str, ctx) -> dict:
    """Each of the cell's metrics of ``section`` from its reader; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.metrics(section):
        value = harness.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(ctx, chips: int) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    tr = ctx.get("trace")
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def execute(args, device, t_start: float, cell: harness.Cell):
    """The run itself: (ctx, result line without checks)."""
    system = harness.load_module("systems", cell.config["system"])
    traffic = harness.load_module("traffic", cell.workload["traffic"])
    ctx = system.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, traffic, t_start)
    section = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(cell, section, ctx)
    checks = ctx["checks"]
    correct = ctx["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(ctx["attempted"]),
              "failed": int(ctx["failed"]), "metrics": metrics,
              "device": device_info(ctx, cell.chips)}
    tr = ctx.get("trace")
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    return ctx, result


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    try:
        device = harness.require_devices(cell.chips)
    except harness.NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(4)
    print(f"card: {harness.card_note()}", file=sys.stderr, flush=True)
    ctx, result = execute(args, device, T_START, cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {harness.card_note()}", file=sys.stderr, flush=True)
    harness.emit(result, ctx["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
