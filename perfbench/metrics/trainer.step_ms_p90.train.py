"""90th percentile of the unprofiled steps' host times (feed, step and
the loss's read)."""
from perfbench import readers


def read(ctx):
    return readers.pct([(s["t1"] - s["t0"]) * 1e3
                        for s in readers.unprofiled_steps(ctx)], 0.90)
