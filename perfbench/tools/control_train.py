"""Read a training cell's check numbers on the card, for several seeds:
the program's (its set-up and first steps, as a run makes them), and
those of the reference put in the program's place: its control (every
weight product, matrix and input, through float8 e4m3 in the forward,
with straight-through gradients) and the planted fault of half the
batch left out (the mean taken over the rest), each held against the
f32 reference of the same seed's weights and rows, by the same
comparison a run makes.

    python3 perfbench/tools/control_train.py \
        --workload smollm135m.train.s2048 --seeds 11,12,13

One JSON line a seed. A state left unchanged reads 1 on the change's
number by construction and needs no run.
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
from perfbench.systems import train as train_sys  # noqa: E402
from perfbench.traffic import train_steps  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    device = harness.require_devices(cell.chips)
    import torch
    config, p = cell.config, cell.workload["params"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        tr, prog = train_sys.build(cell, seed, device, False, train_steps)
        params0 = tr.params0
        train_sys.stop(tr)
        corpus = train_steps.Corpus(config["model"]["vocab_size"], seed,
                                    p["noise"])
        batches = [torch.as_tensor(corpus.batch(i, p["batch"], p["seq"]),
                                   device=device)
                   for i in range(int(p["first_steps"]))]
        hp = config["optimizer"]
        ref = train_sys.reference_steps(params0, config["model"], hp,
                                        batches)
        ctl = train_sys.reference_steps(params0, config["model"], hp,
                                        batches, fp8=True)
        half = train_sys.reference_steps(
            params0, config["model"], hp,
            [b[: b.shape[0] // 2] for b in batches])
        row = {"seed": seed}
        leaves = {}
        for name, got in (("program", prog), ("control", ctl),
                          ("half_batch", half)):
            leaves[name] = {}
            row[name] = train_sys.compare(got, ref, leaves[name])
        row.update(worst_leaves=leaves, losses=ref["losses"],
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        del params0, prog, ref, ctl, half
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
