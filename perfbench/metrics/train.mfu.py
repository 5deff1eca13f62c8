"""The training step's share of the card's bf16 peak: three times the
forward's FLOPs (recomputation not counted) of the unprofiled steps,
over their time, over 989.4 TFLOP/s."""
from perfbench import readers, work


def read(ctx):
    steps = readers.unprofiled_steps(ctx)
    if not steps:
        return None
    p = ctx["workload_params"]
    flops = len(steps) * work.train_flops(ctx["model"], p["batch"], p["seq"])
    took = sum(s["t1"] - s["t0"] for s in steps)
    return 100.0 * flops / took / work.PEAK_FLOPS
